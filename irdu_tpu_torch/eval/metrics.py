"""Metrics with the reference eval's quantization conventions
(a copy of ``irdu_tpu/eval/metrics.py``'s ``img_as_ubyte`` and ``psnr_255``)."""

from __future__ import annotations

import numpy as np


def img_as_ubyte(x: np.ndarray) -> np.ndarray:
    """skimage.img_as_ubyte for float input in [-1, 1]: clip(rint(x·255), 0, 255)."""
    return np.clip(np.rint(np.asarray(x, dtype=np.float64) * 255.0), 0, 255).astype(np.uint8)


def psnr_255(reference_255: np.ndarray, restored_255: np.ndarray) -> float:
    """PSNR in the 255-scale uint8 domain: 20·log10(255/√MSE)."""
    mse = float(np.mean(np.square(
        np.asarray(reference_255, np.float64) - np.asarray(restored_255, np.float64))))
    if mse == 0:
        return float("inf")
    return 20.0 * float(np.log10(255.0 / np.sqrt(mse)))
