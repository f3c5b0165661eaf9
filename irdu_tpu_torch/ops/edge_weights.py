"""K2: per-pixel softmax edge weights of the latent graphs, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw``
(body ``_edgew_kernel``). For each pixel and graph: L2-normalize the F node
features (norm clamped at 1e-12), scale by the metric diagonal multiM, take
the dot product with each neighbour of the window (replicate-padded), softmax
over the E edges. The window is cross-4 for the flagship (E = 4),
diamond-12 for the pixel family (E = 12, offsets up to distance 2) and
ring-8 for GLR boosting (E = 8, the 3×3 ring). Compute in f32; output in
the input dtype.

On the card (``kernels/csrc/edge_weights.cu``): the work is ~(4E + 2)
flops per feature and pixel against 2-4 bytes per feature read, so it is
bound by device-memory bytes (features read once, weights written once). One
CTA takes one graph and a tile of rows (the band), and copies the band plus
the window's radius rows (1 for cross-4 and ring-8, 2 for diamond-12) of its
feature planes into shared memory 16 bytes at a time (cp.async), F planes at
once or in chunks of fc when they do not fit (``plan_edge_tiles``), with the
replicate pad of the image's edges filled in beside them. Each thread takes 8 adjacent
pixels of a row in bf16 (4 in f32), so that neighbouring columns come from
shared memory and each edge's output leaves in one 16-byte store; it keeps
the E metric-weighted dots of its pixels in registers, while the squared
norms are summed once per position of the band and shared by the neighbours
that read them. Compute in f32, then the softmax over E and the output in
the input dtype. The metric diagonal is read in its own dtype (f32 or bf16).
"""

from __future__ import annotations

import functools

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops.graph import at_least_f32, extract_edge_weights
from irdu_tpu_torch.ops.windows import CROSS4, DIAMOND12, RING8, window_radius

# the windows the kernel is built for, by E
KERNEL_WINDOWS = {4: CROSS4, 8: RING8, 12: DIAMOND12}
EDGE_PAD = 8          # shared-memory columns beside a tile, each side
EDGE_ROWS, EDGE_TX = 16, 8  # a CTA's band: rows, and threads a row
EDGE_SMEM = 48 * 1024  # shared memory a plan keeps to, unless one feature plane is more
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block can use


def edge_weights_plain(feats: torch.Tensor, multi_m: torch.Tensor,
                       n_graphs: int, deltas=CROSS4) -> torch.Tensor:
    """feats (B, G·F, H, W), multi_m (G, F) → weights (B, G, E, H, W):
    ``ops.graph.extract_edge_weights`` in f32, returned in the input dtype."""
    return extract_edge_weights(at_least_f32(feats), at_least_f32(multi_m), n_graphs,
                                deltas).to(feats.dtype)


def _check(feats, multi_m, n_graphs):
    if feats.dim() != 4:
        raise ValueError(f"feats must be (B, C, H, W), got {tuple(feats.shape)}")
    b, c, h, w = feats.shape
    if c % n_graphs:
        raise ValueError(f"{c} channels do not split into {n_graphs} graphs")
    if tuple(multi_m.shape) != (n_graphs, c // n_graphs):
        raise ValueError(f"multi_m must be {(n_graphs, c // n_graphs)}, "
                         f"got {tuple(multi_m.shape)}")


def edge_smem_bytes(esize: int, fc: int, f: int, bh: int, tx: int, radius: int) -> int:
    """Shared memory of one CTA, as the kernel lays it out: fc feature planes
    of the tile's bh + 2·radius rows by tx·(16 / esize) + 2·EDGE_PAD columns in
    the input dtype, the f32 squared norms of those positions, the F squared
    metric entries; the first two parts 16-byte aligned."""
    rows, cols = bh + 2 * radius, tx * (16 // esize) + 2 * EDGE_PAD

    def seg(n):
        return -(-n // 16) * 16

    return seg(esize * fc * rows * cols) + seg(4 * rows * cols) + 4 * f


@functools.lru_cache(maxsize=None)
def plan_edge_tiles(f: int, esize: int, radius: int) -> tuple[int, int, int, int]:
    """(bh rows, tx threads a row, fc features a chunk, smem bytes) of a
    launch: bands of EDGE_ROWS rows, EDGE_TX threads a row (each taking
    16 / esize pixels), and the most features a chunk within EDGE_SMEM (at
    least one). This band was the fastest, or within 7 % of it, at every K2
    shape of the 512x512 flagship request and of the pixel model's
    diamond-12 call in a sweep of bands of 1-64 rows by 2-8 threads on the
    H100 (``python -m irdu_tpu_torch.kernels.plan_sweep``); thinner bands,
    which give the small planes of scales 2-3 more CTAs, were slower there."""
    bh, tx = EDGE_ROWS, EDGE_TX
    per_feature = edge_smem_bytes(esize, 1, f, bh, tx, radius) - edge_smem_bytes(
        esize, 0, f, bh, tx, radius)
    fc = max(1, min(f, (EDGE_SMEM - edge_smem_bytes(esize, 0, f, bh, tx, radius))
                    // per_feature))
    smem = edge_smem_bytes(esize, fc, f, bh, tx, radius)
    if smem > SMEM_LIMIT:
        raise ValueError(f"no edge-weight plan fits F={f} in {SMEM_LIMIT} bytes")
    return bh, tx, fc, smem


def edge_weights_chw(feats: torch.Tensor, multi_m: torch.Tensor, *,
                     n_graphs: int, deltas=CROSS4) -> torch.Tensor:
    """Softmax edge weights (B, G, E, H, W) of features (B, G·F, H, W) over
    the window ``deltas`` (E offsets, cross-4 by default).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (f32 or bf16 features, contiguous; multi_m read as it is when it is f32
    or bf16 and contiguous, else cast to f32; the cross-4, ring-8 or
    diamond-12 window)."""
    refuse_grad("edge_weights_chw", feats, multi_m)
    _check(feats, multi_m, n_graphs)
    if library.tracing():
        return _OP(feats, multi_m, n_graphs, library.flat_deltas(deltas))
    return _run(feats, multi_m, n_graphs, deltas)


def _run(feats, multi_m, n_graphs, deltas):
    """The untraced call: the plain version on the CPU, else the launch."""
    if feats.device.type == "cpu":
        return edge_weights_plain(feats, multi_m, n_graphs, deltas)
    if feats.device.type != "cuda" or not feats.is_contiguous():
        raise ValueError("edge_weights_chw needs a contiguous CUDA or CPU tensor")
    n_e = len(deltas)
    if tuple(map(tuple, deltas)) != KERNEL_WINDOWS.get(n_e):
        raise ValueError(f"the kernel takes the cross-4, ring-8 and diamond-12 windows, "
                         f"not {deltas}")
    radius = window_radius(deltas)
    b, c, h, w = feats.shape
    f = c // n_graphs
    m = multi_m
    if m.dtype not in (torch.float32, torch.bfloat16) or not m.is_contiguous():
        m = m.float().contiguous()
    if m.device != feats.device:
        raise ValueError(f"edge_weights_chw: multi_m must be on {feats.device}")
    bh, tx, fc, _ = plan_edge_tiles(f, feats.element_size(), radius)
    out = torch.empty((b, n_graphs, n_e, h, w), dtype=feats.dtype, device=feats.device)
    lib = kernel_library()
    status = lib.irdu_edge_weights(
        feats.data_ptr(), m.data_ptr(), out.data_ptr(), b, n_graphs, f, h, w,
        n_e, dtype_code(feats.dtype), dtype_code(m.dtype), bh, tx, fc,
        torch.cuda.current_stream(feats.device).cuda_stream)
    check_status("edge_weights_chw", status)
    edge_weights_chw.launches += 1
    return out


edge_weights_chw.launches = 0
_OP = library.define(
    "edge_weights_chw(Tensor feats, Tensor multi_m, int n_graphs, int[] deltas) -> Tensor",
    lambda feats, multi_m, n_graphs, deltas: _run(feats, multi_m, n_graphs,
                                                  library.window(deltas)),
    lambda feats, multi_m, n_graphs, deltas: feats.new_empty(
        (feats.shape[0], n_graphs, len(deltas) // 2, *feats.shape[2:])))
