"""Graph stencil operators in per-plane CHW form.

Signals are tensors whose last two axes are (H, W); everything before them
(batch, graph, node feature) broadcasts. Edge weights are a sequence of E
tensors, one per edge of the window ``deltas`` (cross-4 by default),
broadcastable against the signal. Stencil coefficients
``p = (p01, p02a, p02b, p03)`` broadcast the same way. Neighbour reads clamp
at the image edge, the Cᵀ scatter and the transposed stencil read zeros, and
the stencil pads by ``pad_mode`` ("edge" for the flagship, "reflect" for the
pixel family).
These are the plain formulations the kernels' plain versions are built from
(counterpart: ``irdu_tpu/ops/graph.py``, flat NHWC form).
"""

from __future__ import annotations

from typing import Sequence

import torch

from irdu_tpu_torch.ops.shifts import shift2d
from irdu_tpu_torch.ops.windows import CROSS4

Stats = Sequence[torch.Tensor]


def box_down2x2(x: torch.Tensor) -> torch.Tensor:
    """Fixed 2×2 box mean over the last two axes (the solver's down-scale)."""
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
                   + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])


def box_up2x2(t: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``box_down2x2``: duplicate each pixel 2×2 AND scale by 0.25."""
    return 0.25 * t.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, the compute type of the kernels and of their plain
    versions, or as it is in f64 (a float64 gradient check of the plain
    route)."""
    return t if t.dtype == torch.float64 else t.float()


def stats_table_terms(tab: torch.Tensor | None) -> Stats | None:
    """A (G, 4, F) stats table as the four coefficients, each (G, F, 1, 1) f32
    (broadcast over the planes of (…, G, F, H, W) signals); None stays None."""
    if tab is None:
        return None
    tab = at_least_f32(tab)
    return [tab[:, k, :, None, None] for k in range(4)]


def stats_conv(x: torch.Tensor, p: Stats | None, pad_mode: str = "edge") -> torch.Tensor:
    """Learned polynomial 3×3 stencil: p01·δ + p02a·∂ₓ + p02b·∂ᵧ + p03·(4δ−N−S−E−W),
    boundary by ``pad_mode`` (reference stats_conv); ``p=None`` (no stencil)
    is the identity."""
    if p is None:
        return x
    r = shift2d(x, 0, 1, pad_mode)
    d = shift2d(x, 1, 0, pad_mode)
    u = shift2d(x, -1, 0, pad_mode)
    l = shift2d(x, 0, -1, pad_mode)
    return (p[0] * x + p[1] * (r - x) + p[2] * (d - x)
            + p[3] * (4.0 * x - u - d - l - r))


def stats_conv_transpose(x: torch.Tensor, p: Stats | None) -> torch.Tensor:
    """The reference's adjoint of ``stats_conv``: flipped taps, zero boundary."""
    if p is None:
        return x
    r0 = shift2d(x, 0, 1, "zero")
    d0 = shift2d(x, 1, 0, "zero")
    u0 = shift2d(x, -1, 0, "zero")
    l0 = shift2d(x, 0, -1, "zero")
    return (p[0] * x + p[1] * (l0 - x) + p[2] * (u0 - x)
            + p[3] * (4.0 * x - u0 - d0 - l0 - r0))


def op_c(x, w, p, deltas=CROSS4, pad_mode="edge"):
    """Graph gradient after the stencil: per edge ``w_e·(s − shift_e s)``,
    neighbours read with replicate padding."""
    s = stats_conv(x, p, pad_mode)
    return [w[e] * (s - shift2d(s, dh, dw)) for e, (dh, dw) in enumerate(deltas)]


def op_c_transpose(eps, w, p, deltas=CROSS4):
    """Graph divergence Cᵀε: Σ_e w_e·ε_e − shift_{−δe}^{zero}(w_e·ε_e), then
    the transposed stencil."""
    acc = None
    for e, (dh, dw) in enumerate(deltas):
        we = w[e] * eps[e]
        term = we - shift2d(we, -dh, -dw, "zero")
        acc = term if acc is None else acc + term
    return stats_conv_transpose(acc, p)


def gtv_apply(x, w, p, deltas=CROSS4, pad_mode="edge"):
    """GGTV operator CᵀC."""
    return op_c_transpose(op_c(x, w, p, deltas, pad_mode), w, p, deltas)


def gtv_rethresh_apply(x, w, p, gamma, deltas=CROSS4, pad_mode="edge"):
    """The ADMM re-threshold Cᵀ(2·S_γ(Cx) − Cx)."""
    eps = op_c(x, w, p, deltas, pad_mode)
    return op_c_transpose([2.0 * soft_threshold(e, gamma) - e for e in eps], w, p, deltas)


def glr_apply(x, w, p, deltas=CROSS4, pad_mode="edge"):
    """GGLR operator statsᵀ ∘ (I − W·shift) ∘ stats."""
    s = stats_conv(x, p, pad_mode)
    acc = None
    for e, (dh, dw) in enumerate(deltas):
        term = w[e] * shift2d(s, dh, dw)
        acc = term if acc is None else acc + term
    return stats_conv_transpose(s - acc, p)


_NORMALIZE_EPS = 1e-12  # torch.nn.functional.normalize's


def _split_graphs(x: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """(B, G·C, H, W) as its (B, G, C, H, W) view."""
    b, c, h, w = x.shape
    return x.reshape(b, n_graphs, c // n_graphs, h, w)


def normalize_features(feats: torch.Tensor, multi_m: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """Node features (B, G·F, H, W) L2-normalized within each graph's F
    block (the norm clamped at 1e-12), then scaled by the metric diagonal
    ``multi_m`` (G, F); returned as (B, G, F, H, W)."""
    x = _split_graphs(feats, n_graphs)
    norm = torch.sqrt(torch.sum(x * x, dim=2, keepdim=True))
    return x / torch.clamp(norm, min=_NORMALIZE_EPS) * multi_m[None, :, :, None, None]


def extract_edge_weights(feats: torch.Tensor, multi_m: torch.Tensor, n_graphs: int,
                         deltas=CROSS4) -> torch.Tensor:
    """Row-stochastic edge weights (B, G, E, H, W) of features (B, G·F, H, W):
    the dot product over F of the normalized, metric-scaled features of the
    pixel and of each neighbour of ``deltas`` (replicate-padded), softmax
    over the E edges; in the features' dtype. (JAX also returns the softmax
    row sums, identically 1.)"""
    t = normalize_features(feats, multi_m, n_graphs)
    sims = [torch.sum(t * shift2d(t, dh, dw), dim=2) for dh, dw in deltas]
    return torch.softmax(torch.stack(sims, dim=2), dim=2)


def op_l_norm(x: torch.Tensor, weights: torch.Tensor, n_graphs: int,
              deltas=CROSS4) -> torch.Tensor:
    """Random-walk normalized Laplacian ``x − Σ_e w_e ⊙ shift_e(x)`` of
    x (B, G·C, H, W), each graph's C planes weighted by its weights
    (B, G, E, H, W), neighbours read with replicate padding."""
    xg = _split_graphs(x, n_graphs)
    acc = None
    for e, (dh, dw) in enumerate(deltas):
        term = weights[:, :, e:e + 1] * shift2d(xg, dh, dw)
        acc = term if acc is None else acc + term
    return (xg - acc).reshape(x.shape)


def per_graph_scale(x: torch.Tensor, vec_g: torch.Tensor) -> torch.Tensor:
    """x (B, G·C, H, W) times a per-graph vector (G,), broadcast over C."""
    return (_split_graphs(x, vec_g.shape[0]) * vec_g[None, :, None, None, None]).reshape(x.shape)


def soft_threshold(delta: torch.Tensor, gamma) -> torch.Tensor:
    """Edge-domain soft shrinkage S_γ."""
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
    return (torch.where(delta < -gamma, delta + gamma, zero)
            + torch.where(delta > gamma, delta - gamma, zero))


def pack_edge_weights(w: torch.Tensor) -> torch.Tensor:
    """Edge weights (B, G, E, H, W) packed channels-last for K8:
    (B, H, W, E·G) with index e·G + g."""
    b, g, e, h, wd = w.shape
    return w.permute(0, 3, 4, 2, 1).reshape(b, h, wd, e * g).contiguous()

