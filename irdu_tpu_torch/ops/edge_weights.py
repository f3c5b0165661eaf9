"""K2: per-pixel softmax edge weights of the latent graphs, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw``
(body ``_edgew_kernel``). For each pixel and graph: L2-normalize the F node
features (norm clamped at 1e-12), scale by the metric diagonal multiM, take
the dot product with each neighbour of the window (replicate-padded), softmax
over the E edges. The window is cross-4 for the flagship (E = 4) and
diamond-12 for the pixel family (E = 12, offsets up to distance 2). Compute
in f32; output in the input dtype.

On the card (``kernels/csrc/edge_weights.cu``): one thread per
(batch, graph, pixel). It reads the F features at the centre and at its E
neighbours once and accumulates the E + 1 squared norms and the E
metric-weighted dot products in one pass, so normalization costs no second
read. The window's offset table goes to the kernel by value and E is a
template parameter (4 or 12). The work is ~(4E + 2) flops per feature and
pixel against 2-4 bytes per feature read, so it is bound by device-memory
bytes (features read once, weights written once); neighbouring threads take
neighbouring pixels of a row, so every read and write is coalesced, and the
neighbour reads hit L1/L2.
"""

from __future__ import annotations

import ctypes

import torch

from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library
from irdu_tpu_torch.ops.shifts import shift2d
from irdu_tpu_torch.ops.windows import CROSS4

_NORMALIZE_EPS = 1e-12
KERNEL_EDGES = (4, 12)  # the window sizes the kernel is built for: cross-4, diamond-12


def edge_weights_plain(feats: torch.Tensor, multi_m: torch.Tensor,
                       n_graphs: int, deltas=CROSS4) -> torch.Tensor:
    """feats (B, G·F, H, W), multi_m (G, F) → weights (B, G, E, H, W)."""
    b, c, h, w = feats.shape
    f = c // n_graphs
    x = feats.float().reshape(b, n_graphs, f, h, w)
    norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
    t = x / torch.clamp(norm, min=_NORMALIZE_EPS)
    t = t * multi_m.float().reshape(1, n_graphs, f, 1, 1)
    sims = [torch.sum(t * shift2d(t, dh, dw), dim=2) for dh, dw in deltas]
    return torch.softmax(torch.stack(sims, dim=2), dim=2).to(feats.dtype)


def _check(feats, multi_m, n_graphs):
    if feats.dim() != 4:
        raise ValueError(f"feats must be (B, C, H, W), got {tuple(feats.shape)}")
    b, c, h, w = feats.shape
    if c % n_graphs:
        raise ValueError(f"{c} channels do not split into {n_graphs} graphs")
    if tuple(multi_m.shape) != (n_graphs, c // n_graphs):
        raise ValueError(f"multi_m must be {(n_graphs, c // n_graphs)}, "
                         f"got {tuple(multi_m.shape)}")


def window_arg(deltas):
    """The window as the kernels take it: a C int array of (dh, dw) pairs."""
    flat = [v for d in deltas for v in d]
    return (ctypes.c_int * len(flat))(*flat)


def edge_weights_chw(feats: torch.Tensor, multi_m: torch.Tensor, *,
                     n_graphs: int, deltas=CROSS4) -> torch.Tensor:
    """Softmax edge weights (B, G, E, H, W) of features (B, G·F, H, W) over
    the window ``deltas`` (E offsets, cross-4 by default).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (f32 or bf16 features, contiguous; multi_m any float type, cast to f32;
    E of 4 or 12)."""
    _check(feats, multi_m, n_graphs)
    if feats.device.type == "cpu":
        return edge_weights_plain(feats, multi_m, n_graphs, deltas)
    if feats.device.type != "cuda" or not feats.is_contiguous():
        raise ValueError("edge_weights_chw needs a contiguous CUDA or CPU tensor")
    n_e = len(deltas)
    if n_e not in KERNEL_EDGES:
        raise ValueError(f"the kernel takes windows of {KERNEL_EDGES} edges, not {n_e}")
    b, c, h, w = feats.shape
    m = multi_m.to(device=feats.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, n_graphs, n_e, h, w), dtype=feats.dtype, device=feats.device)
    lib = kernel_library()
    status = lib.irdu_edge_weights(
        feats.data_ptr(), m.data_ptr(), out.data_ptr(), b, n_graphs,
        c // n_graphs, h, w, window_arg(deltas), n_e, dtype_code(feats.dtype),
        torch.cuda.current_stream(feats.device).cuda_stream)
    check_status("edge_weights_chw", status)
    edge_weights_chw.launches += 1
    return out


edge_weights_chw.launches = 0
