"""K2: per-pixel softmax edge weights of the latent graphs, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw``
(body ``_edgew_kernel``). For each pixel and graph: L2-normalize the F node
features (norm clamped at 1e-12), scale by the metric diagonal multiM, take
the dot product with each cross-4 neighbour (replicate-padded), softmax over
the 4 edges. Compute in f32; output in the input dtype.

On the card (``kernels/csrc/edge_weights.cu``): one thread per
(batch, graph, pixel). It reads the F features at the centre and at its 4
neighbours once and accumulates the 5 squared norms and the 4 metric-weighted
dot products in one pass, so normalization costs no second read. The work is
~20 flops per feature and pixel against 2-4 bytes per feature read, so it is
bound by device-memory bytes (features read once, weights written once);
neighbouring threads take neighbouring pixels of a row, so every read and
write is coalesced, and the 4 neighbour reads hit L1/L2.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library
from irdu_tpu_torch.ops.shifts import shift2d
from irdu_tpu_torch.ops.windows import CROSS4

_NORMALIZE_EPS = 1e-12


def edge_weights_plain(feats: torch.Tensor, multi_m: torch.Tensor,
                       n_graphs: int) -> torch.Tensor:
    """feats (B, G·F, H, W), multi_m (G, F) → weights (B, G, 4, H, W)."""
    b, c, h, w = feats.shape
    f = c // n_graphs
    x = feats.float().reshape(b, n_graphs, f, h, w)
    norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
    t = x / torch.clamp(norm, min=_NORMALIZE_EPS)
    t = t * multi_m.float().reshape(1, n_graphs, f, 1, 1)
    sims = [torch.sum(t * shift2d(t, dh, dw), dim=2) for dh, dw in CROSS4]
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


def edge_weights_chw(feats: torch.Tensor, multi_m: torch.Tensor, *,
                     n_graphs: int) -> torch.Tensor:
    """Softmax cross-4 edge weights (B, G, 4, H, W) of features (B, G·F, H, W).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (f32 or bf16 features, contiguous; multi_m any float type, cast to f32)."""
    _check(feats, multi_m, n_graphs)
    if feats.device.type == "cpu":
        return edge_weights_plain(feats, multi_m, n_graphs)
    if feats.device.type != "cuda" or not feats.is_contiguous():
        raise ValueError("edge_weights_chw needs a contiguous CUDA or CPU tensor")
    b, c, h, w = feats.shape
    m = multi_m.to(device=feats.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, n_graphs, 4, h, w), dtype=feats.dtype, device=feats.device)
    lib = kernel_library()
    status = lib.irdu_edge_weights(
        feats.data_ptr(), m.data_ptr(), out.data_ptr(), b, n_graphs,
        c // n_graphs, h, w, dtype_code(feats.dtype),
        torch.cuda.current_stream(feats.device).cuda_stream)
    check_status("edge_weights_chw", status)
    edge_weights_chw.launches += 1
    return out


edge_weights_chw.launches = 0
