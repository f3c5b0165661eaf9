"""YCbCr colour helpers (a copy of ``irdu_tpu/data/color.py``): ITU-R BT.601
on the 255 scale, as skimage.color computes it."""

from __future__ import annotations

import numpy as np

# rgb in [0, 1] -> 255-scale YCbCr
_FWD = np.array([
    [65.481, 128.553, 24.966],
    [-37.797, -74.203, 112.0],
    [112.0, -93.786, -18.214],
])
_OFFSET = np.array([16.0, 128.0, 128.0])


def rgb2ycbcr(rgb: np.ndarray) -> np.ndarray:
    """rgb float in [0,1] (HWC) -> YCbCr in 255-scale (Y in [16,235])."""
    return rgb @ _FWD.T + _OFFSET


def ycbcr2rgb(ycbcr: np.ndarray) -> np.ndarray:
    """Inverse of rgb2ycbcr."""
    return (ycbcr - _OFFSET) @ np.linalg.inv(_FWD).T
