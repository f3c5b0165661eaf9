"""Tiled and spatially sharded inference (counterpart:
``irdu_tpu/parallel/spatial.py``).

The graph operators are local and the flagship's receptive field is finite
(3 down-scales plus the solver's own 2×), so an image can run as
overlapping tiles whose halos cover that field, each tile cropped to its
core and the cores stitched: close to whole-image inference with the memory
of one tile. The halo's edge still differs from the whole image's context,
so the stitched result is not bit-equal to a whole-image forward.

Three entry points, as in JAX:
  * ``tiled_forward``: tiles one after another on one device;
  * ``sharded_tiled_forward``: every equal-sized window of the image, the
    windows split over the ranks of a mesh's data axis, each rank's share as
    one batch on its device, the outputs gathered (JAX: one batch sharded
    over the "data" axis);
  * ``halo_shard_forward``: the image's rows split over the ranks, each
    rank holding only its core rows and receiving its neighbours' edge rows
    by point-to-point transfers (JAX: two ``lax.ppermute``), the model run
    on each rank's shifted window and the cores gathered.

Each rank returns the whole float32 HWC image. ``forward`` there takes a
float32 NHWC tensor on the rank's device and returns one
(``predict.batch_forward(model)`` does).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from irdu_tpu_torch.eval.harness import to_numpy
from irdu_tpu_torch.parallel.mesh import Mesh, all_gather_host, host_staged, make_mesh


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


def _axis_windows(size: int, step: int, halo: int):
    """Clamped window anchors along one axis: ([(core_start, read_start)],
    pad). Each window is ``step + 2·halo`` long and lies inside [0, size),
    the last core ragged when size % step != 0, except when the axis is
    shorter than one window: then it is edge-padded up to a multiple of 16
    and read as one whole-axis window (``pad`` > 0), which still gets one
    core anchor per ``step``, so that the stitch covers the whole axis
    (sizes in (step, step + 2·halo) need ⌈size/step⌉ cores though they fit
    one window)."""
    win = step + 2 * halo
    if size >= win:
        return [(i * step, min(max(i * step - halo, 0), size - win))
                for i in range(math.ceil(size / step))], 0
    return [(i * step, 0) for i in range(math.ceil(size / step))], (-size) % 16


def sharded_tiled_forward(forward: Callable[[torch.Tensor], torch.Tensor], image: np.ndarray,
                          mesh: Mesh | None = None, *, tile: int = 256,
                          halo: int = 32) -> np.ndarray:
    """Every halo'd window of one HWC image, the windows split over the
    mesh's data axis (default: every rank), each rank's share run as one
    batch on its device, the outputs gathered and stitched on every rank.

    The windows are JAX's: each ``tile + 2·halo`` long (the whole axis where
    it is shorter) and shifted inward at the image's edges, so that the true
    edge is a window's edge and the model applies its own boundary rule
    there; only an axis shorter than one window is edge-padded (to a
    multiple of 16). The list is padded with zero windows to a multiple of
    the ranks, and rank i takes the i-th contiguous share."""
    mesh = mesh or make_mesh()
    h, w = image.shape[:2]
    hspan, ph = _axis_windows(h, tile, halo)
    wspan, pw = _axis_windows(w, tile, halo)
    padded = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge") if ph or pw else image
    win_h, win_w = min(tile + 2 * halo, h + ph), min(tile + 2 * halo, w + pw)
    anchors = [(r0, rs, c0, cs) for r0, rs in hspan for c0, cs in wspan]
    per_rank = -(-len(anchors) // mesh.dp)
    mine = anchors[mesh.data_index * per_rank:(mesh.data_index + 1) * per_rank]
    batch = np.zeros((per_rank, win_h, win_w, image.shape[2]), np.float32)
    for k, (_, rs, _, cs) in enumerate(mine):
        batch[k] = padded[rs:rs + win_h, cs:cs + win_w]
    out = forward(torch.from_numpy(batch).to(mesh.device)).float()
    outs = all_gather_host(out, mesh.data_group).numpy()

    result = np.zeros_like(image, dtype=np.float32)
    for (r0, rs, c0, cs), o in zip(anchors, outs):
        r1, c1 = min(r0 + tile, h), min(c0 + tile, w)
        result[r0:r1, c0:c1] = o[r0 - rs:r1 - rs, c0 - cs:c1 - cs]
    return result


def _exchange_edges(core: torch.Tensor, rows: int, mesh: Mesh):
    """(the previous rank's last ``rows`` rows, the next rank's first
    ``rows`` rows) of (1, hs, W, C) cores, None past the first and the
    last rank: JAX's two ``ppermute``s, as one batch of point-to-point
    transfers (through host buffers under gloo, on the device under NCCL)."""
    i, n, group = mesh.data_index, mesh.dp, mesh.data_group
    staged = host_staged(group)
    src = core.cpu() if staged else core
    shape = (1, rows) + tuple(core.shape[2:])

    def buf():
        return torch.empty(shape, dtype=core.dtype, device=src.device)

    ops, prev_tail, next_head = [], None, None
    if i > 0:
        prev_tail, peer = buf(), dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, src[:, :rows].contiguous(), peer, group),
                dist.P2POp(dist.irecv, prev_tail, peer, group)]
    if i < n - 1:
        next_head, peer = buf(), dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, src[:, -rows:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, next_head, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(None if t is None else t.to(core.device) for t in (prev_tail, next_head))


def halo_shard_forward(forward: Callable[[torch.Tensor], torch.Tensor], image: np.ndarray,
                       mesh: Mesh | None = None, *, halo: int = 64) -> np.ndarray:
    """Spatially parallel inference of one HWC image: its rows split over
    the mesh's data axis (default: every rank), the ``2·halo`` edge rows
    exchanged with the neighbouring ranks, the model run on each rank's
    shifted window of ``rows_per_rank + 2·halo`` real rows:

      rank 0      rows [0, hs + 2·halo)                (the true top),
      rank i      rows [i·hs − halo, (i+1)·hs + halo),
      rank n − 1  rows [H − hs − 2·halo, H)            (the true bottom),

    so every core row has ``halo`` rows of real context or sits at the true
    edge, each rank's core kept and the cores gathered on every rank.

    H and W are reflect-padded to multiples of ``16·n`` and 16 and cropped
    back. Each rank places only its own core rows on its device; the rows
    of its window beyond its core come from its neighbours, never from its
    own copy of the image. ``halo % 8 == 0`` and rows per rank ≥ ``2·halo``
    (JAX's asserts). With one rank: the whole image, reflect-padded to /16."""
    mesh = mesh or make_mesh()
    n, i = mesh.dp, mesh.data_index
    h, w = image.shape[:2]
    if n == 1:
        x = np.pad(image, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="reflect")
        y = forward(torch.from_numpy(np.ascontiguousarray(x[None], np.float32)).to(mesh.device))
        return to_numpy(y)[0, :h, :w]

    assert halo % 8 == 0, "halo must be a multiple of 8 (window % 16 == 0)"
    r = halo
    x = np.pad(image, ((0, (-h) % (16 * n)), (0, (-w) % 16), (0, 0)), mode="reflect")
    hs = x.shape[0] // n
    assert hs >= 2 * r, f"rows/device {hs} < 2·halo {2 * r}: use fewer devices or less halo"
    core = torch.from_numpy(np.ascontiguousarray(x[None, i * hs:(i + 1) * hs], np.float32))
    core = core.to(mesh.device)
    prev_tail, next_head = _exchange_edges(core, 2 * r, mesh)
    if i == 0:  # the true top: core and 2·halo rows of the next rank
        win, off = torch.cat([core, next_head], dim=1), 0
    elif i == n - 1:  # the true bottom: 2·halo rows of the previous rank and core
        win, off = torch.cat([prev_tail, core], dim=1), 2 * r
    else:  # centred: halo rows on either side
        win, off = torch.cat([prev_tail[:, r:], core, next_head[:, :r]], dim=1), r
    y = forward(win).float()[:, off:off + hs]
    return all_gather_host(y[0], mesh.data_group).numpy()[:h, :w]
