"""Metrics with the reference eval's quantization conventions (a copy of
``irdu_tpu/eval/metrics.py``: ``img_as_ubyte``, ``psnr_255``, ``psnr_unit``,
``ssim_255``; numpy, and scipy for SSIM)."""

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


def psnr_unit(reference: np.ndarray, restored: np.ndarray) -> float:
    """PSNR on [0, 1] floats, both clipped first (the training-log metric,
    10·log10(1/MSE))."""
    ref = np.clip(np.asarray(reference, np.float64), 0.0, 1.0)
    res = np.clip(np.asarray(restored, np.float64), 0.0, 1.0)
    mse = float(np.mean(np.square(ref - res)))
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10(1.0 / mse))


def ssim_255(reference_255: np.ndarray, restored_255: np.ndarray,
             win_size: int = 7) -> float:
    """Mean SSIM in the 255-scale domain with skimage's defaults: a uniform
    win_size × win_size window, sample (N − 1) covariances, K1 = 0.01,
    K2 = 0.03, data_range 255, the mean over channels, a border of
    (win_size − 1)/2 left out."""
    from scipy.ndimage import uniform_filter

    x = np.asarray(reference_255, np.float64)
    y = np.asarray(restored_255, np.float64)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")
    c1, c2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
    npix = win_size ** 2
    cov_norm = npix / (npix - 1.0)
    pad = (win_size - 1) // 2
    vals = []
    for c in range(x.shape[-1]):
        xc, yc = x[..., c], y[..., c]
        ux, uy = uniform_filter(xc, win_size), uniform_filter(yc, win_size)
        vx = cov_norm * (uniform_filter(xc * xc, win_size) - ux * ux)
        vy = cov_norm * (uniform_filter(yc * yc, win_size) - uy * uy)
        vxy = cov_norm * (uniform_filter(xc * yc, win_size) - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
        vals.append(np.mean(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad]))
    return float(np.mean(vals))
