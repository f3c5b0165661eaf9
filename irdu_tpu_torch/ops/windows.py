"""Graph connection windows as (dh, dw) edge offsets.

A connection window is a (2r+1)×(2r+1) 0/1 mask centred on a pixel; each
1-entry is an edge to the neighbour at that offset. A shift by (dh, dw) reads
``x[i+dh, j+dw]``; the edge order is row-major over the window, the order the
edge-weight planes are stored in (counterpart: ``irdu_tpu/ops/windows.py``).
"""

from __future__ import annotations

import itertools

import numpy as np


def window_to_deltas(window: np.ndarray) -> tuple[tuple[int, int], ...]:
    """Row-major (dh, dw) offsets of the 1-entries of a centred window."""
    k = window.shape[0]
    m = np.arange(k) - k // 2
    flat = np.asarray(window).reshape(-1)
    return tuple((int(dh), int(dw)) for (dh, dw), on in
                 zip(itertools.product(m, m), flat) if on)


# 4-neighbour cross, the flagship window: up, left, right, down.
CROSS4 = window_to_deltas(np.array([[0, 1, 0],
                                    [1, 0, 1],
                                    [0, 1, 0]]))
# 12-neighbour 5×5 diamond, the pixel-domain family's window.
DIAMOND12 = window_to_deltas(np.array([[0, 0, 1, 0, 0],
                                       [0, 1, 1, 1, 0],
                                       [1, 1, 0, 1, 1],
                                       [0, 1, 1, 1, 0],
                                       [0, 0, 1, 0, 0]]))
# 8-neighbour full 3×3 ring, GLR boosting's window.
RING8 = window_to_deltas(np.array([[1, 1, 1],
                                   [1, 0, 1],
                                   [1, 1, 1]]))

WINDOWS = {"cross4": CROSS4, "diamond12": DIAMOND12, "ring8": RING8}
# The code each window has in the solver kernels (K5, K7, K8: ``Win<>`` in
# kernels/csrc/padded_tile.cuh).
WINDOW_CODES = {CROSS4: 0, DIAMOND12: 1, RING8: 2}
CODE_WINDOWS = {code: deltas for deltas, code in WINDOW_CODES.items()}


def window_radius(deltas) -> int:
    """The rows above and below a pixel that the window reads (1 for
    cross-4 and ring-8, 2 for diamond-12)."""
    return max(abs(dh) for dh, _ in deltas)


def window_code(deltas) -> int | None:
    """The window's code in the solver kernels, or None for a window they
    are not built for."""
    return WINDOW_CODES.get(tuple(tuple(int(v) for v in d) for d in deltas))
