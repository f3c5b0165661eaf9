"""The spatial-shift primitive the graph stencils are built from."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = {"edge": "replicate", "zero": "constant", "reflect": "reflect"}


def shift2d(x: torch.Tensor, dh: int, dw: int, mode: str = "edge") -> torch.Tensor:
    """``out[..., i, j] = x[..., i+dh, j+dw]`` over the last two axes.

    mode "edge" clamps out-of-range reads to the border (replicate pad),
    "zero" reads 0 there, "reflect" mirrors without repeating the edge
    (numpy/torch "reflect")."""
    if mode not in _PAD_MODES:
        raise ValueError(f"unknown shift mode: {mode}")
    if dh == 0 and dw == 0:
        return x
    h, w = x.shape[-2:]
    pad = (max(-dw, 0), max(dw, 0), max(-dh, 0), max(dh, 0))
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, h, w)
    xp = F.pad(x4, pad, mode=_PAD_MODES[mode])
    top, left = max(dh, 0), max(dw, 0)
    out = xp[..., top:top + h, left:left + w]
    return out.reshape(*lead, h, w)
