"""Graph connection windows as (dh, dw) edge offsets.

A shift by (dh, dw) reads ``x[i+dh, j+dw]``; the edge order is row-major
over the window, the order the edge-weight planes are stored in.
"""

# 4-neighbour cross, the flagship window: up, left, right, down.
CROSS4 = ((-1, 0), (0, -1), (0, 1), (1, 0))
