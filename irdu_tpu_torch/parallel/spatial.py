"""Tiled inference on one device (counterpart: ``irdu_tpu/parallel/spatial.py``
``_tile_grid`` and ``tiled_forward``).

The graph operators are local and the flagship's receptive field is finite
(3 down-scales plus the solver's own 2×), so an image can run as
overlapping tiles whose halos cover that field, each tile cropped to its
core and the cores stitched: close to whole-image inference with the memory
of one tile. The halo's edge still differs from the whole image's context,
so the stitched result is not bit-equal to a whole-image forward.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from irdu_tpu_torch.eval.harness import to_numpy


def _tile_grid(size: int, tile: int, halo: int) -> list[tuple[int, int, int, int]]:
    """(core_start, core_end, read_start, read_end) per tile; the cores
    partition [0, size)."""
    spans = []
    for i in range(math.ceil(size / tile)):
        c0, c1 = i * tile, min((i + 1) * tile, size)
        spans.append((c0, c1, max(c0 - halo, 0), min(c1 + halo, size)))
    return spans


def tiled_forward(forward: Callable[[np.ndarray], object], image: np.ndarray, *,
                  tile: int = 256, halo: int = 64, multiple: int = 16) -> np.ndarray:
    """``forward`` ((1, h, w, C) → (1, h, w, C), numpy or tensor) over
    overlapping tiles of one HWC image: each tile's window (its core and up
    to ``halo`` pixels around it) is reflect-padded bottom/right to a
    multiple of ``multiple``, run, and its core kept. Returns float32 HWC."""
    h, w = image.shape[:2]
    out = np.zeros_like(image, dtype=np.float32)
    for hc0, hc1, hr0, hr1 in _tile_grid(h, tile, halo):
        for wc0, wc1, wr0, wr1 in _tile_grid(w, tile, halo):
            patch = image[hr0:hr1, wr0:wr1]
            ph, pw = patch.shape[:2]
            pad_h, pad_w = (multiple - ph % multiple) % multiple, (multiple - pw % multiple) % multiple
            if pad_h or pad_w:
                patch = np.pad(patch, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
            res = to_numpy(forward(patch[None]))[0][:ph, :pw]
            out[hc0:hc1, wc0:wc1] = res[hc0 - hr0:hc1 - hr0, wc0 - wr0:wc1 - wr0]
    return out
