"""The flagship's latent two-scale GGTV+GGLR unrolled ADMM/CG solver
(counterpart: ``irdu_tpu/solvers/gtv_glr.py`` ``MixtureGTVGLR``, its kernel
route ``_forward_chw``).

Channels-first (B, C, H, W) with C = G·F; H and W even. Per call: the two
feature heads, K2 once per scale with the GTV and GLR graphs batched as 2G
graphs, then the unroll on one of two routes, by JAX's rule (``_mega_ok``)
on every window (cross-4, diamond-12, ring-8): a plane of at most
``_MEGA_MAX_PIXELS`` (W rounded up to 128) with both extents within 1024
takes K1, the whole unroll in one call; every other plane takes the band
route, the unroll as K5 steps (rhs, cg, rethresh, cg, cg at cg3; 2 and 4
calls at cg1 and cg2). The reference quirks both keep are listed in
``ops/solver_unroll.py``.

Where JAX runs its jnp path the port runs a kernel route, with the same
arithmetic: JAX's ``_chw_ok`` also asks H % 16 == 0, (H/2) % 8 == 0 and, for
the band route, W % 256 == 0 (TPU tiling and lane rules). A plane that
fails them stays on K1 when ``_mega_ok`` holds and takes K5 otherwise.
JAX sends every window other than cross-4 to its jnp path (``_chw_ok``);
the port sends it to K1 or the band route by the same rule as cross-4, with
the same arithmetic.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irdu_tpu_torch.models.layers import Downsample2x2, GroupedPointwise
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.fused_step import (fused_scal, fused_step_plain, gg_fused_step_chw,
                                           identity_table)
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain, unroll_scal
from irdu_tpu_torch.ops.windows import WINDOWS
from irdu_tpu_torch.solvers.common import GraphOpParams

N_CGD_ITERS = 3  # fixed in the reference
# Planes up to this many pixels take K1 (JAX's whole-unroll VMEM bound, kept
# as the routing rule; tests patch it to force the band route).
_MEGA_MAX_PIXELS = 768 * 1024


def _mega_ok(shape) -> bool:
    """Whether a (B, C, H, W) plane takes K1: H·Wp ≤ ``_MEGA_MAX_PIXELS``
    with Wp = W rounded up to 128, max(H, Wp) ≤ 1024 and W even (JAX's
    ``MixtureGTVGLR._mega_ok`` without its H % 16 rule, see above)."""
    h, w = shape[-2:]
    wp = -(-w // 128) * 128
    return w % 2 == 0 and h * wp <= _MEGA_MAX_PIXELS and max(h, wp) <= 1024


class MixtureGTVGLR(nn.Module):
    """A CPU tensor takes the kernels' plain versions and a CUDA tensor the
    kernels. Setting the attribute ``use_kernels`` to False runs the plain
    versions on any device: the on-card reference the kernel path is held to.

    The options are JAX's, at the flagship's defaults: the graph ``window``
    ("cross4", "diamond12" or "ring8"; each takes K1 or the band route by
    ``_mega_ok``); the initial values of
    α, β and the log-parameterized μ, ρ, γ (per scale); ``stats_mode``
    ("per_channel", "scalar" or "none": a missing stencil goes to K1 and K5
    as the identity table, which is exact); ``feature_head`` "pointwise" (the
    flagship: 1×1 C→2C at full res, 2×2 stride-2 C→C then 1×1 C→2C at half
    res) or "nonlinear3" (the no-latent ablations: ``_NonLinearHead`` at full
    res, and after the 2×2 stride-2 conv at half res)."""

    def __init__(self, n_graphs: int, n_node_fts: int, *, alpha_init: float = 0.5,
                 beta_init: float = 0.1, muy_init=(0.001, 0.0001), ro_init=(0.0001, 0.0001),
                 gamma_init=(0.0001, 0.0001), stats_mode: str = "per_channel",
                 feature_head: str = "pointwise", eval_cg_iters: int = 3,
                 window: str = "cross4"):
        super().__init__()
        g, f = n_graphs, n_node_fts
        c = g * f
        self.n_graphs, self.n_node_fts = g, f
        self.deltas = WINDOWS[window]
        self.eval_cg_iters = eval_cg_iters
        self.use_kernels = True
        self.alphaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), float(alpha_init)))
        self.betaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), float(beta_init)))
        if feature_head == "pointwise":
            self.patchs_features_extraction00 = GroupedPointwise(c, 2 * c)
            self.patchs_features_extraction01_down = Downsample2x2(c, c)
            self.patchs_features_extraction01_point = GroupedPointwise(c, 2 * c)
        elif feature_head == "nonlinear3":
            from irdu_tpu_torch.solvers.ablation_solvers import _NonLinearHead

            self.patchs_features_extraction00 = _NonLinearHead(c, 2 * c)
            self.patchs_features_extraction01_down = Downsample2x2(c, c)
            self.patchs_features_extraction01_head = _NonLinearHead(c, 2 * c)
        else:
            raise ValueError(f"feature_head must be 'pointwise' or 'nonlinear3', "
                             f"got {feature_head!r}")
        self.feature_head = feature_head
        # log-parameterized positive weights
        for name, v in (("ro00", ro_init[0]), ("ro01", ro_init[1]),
                        ("gamma00", gamma_init[0]), ("gamma01", gamma_init[1]),
                        ("muys00", muy_init[0]), ("muys01", muy_init[1])):
            setattr(self, name, nn.Parameter(torch.full((g,), math.log(v))))
        self.GTVmodule00 = GraphOpParams(g, f, stats_mode)
        self.GLRmodule00 = GraphOpParams(g, f, stats_mode)
        self.GTVmodule01 = GraphOpParams(g, f, stats_mode)
        self.GLRmodule01 = GraphOpParams(g, f, stats_mode)
        self.tp = None  # parallel.tensor.ModelShard under the expert split

    def _heads(self, x):
        """The full- and half-res features, each (B, 2C, h, w), GTV first."""
        half = (self.patchs_features_extraction01_point if self.feature_head == "pointwise"
                else self.patchs_features_extraction01_head)
        return (self.patchs_features_extraction00(x),
                half(self.patchs_features_extraction01_down(x)))

    def _tables(self, g):
        """The four (g, 4, F) stats tables of the g graphs held here; a
        missing stencil as the identity."""
        f = self.n_node_fts
        return tuple(identity_table(g, f, mod.multiM.device) if t is None else t
                     for mod in (self.GTVmodule00, self.GLRmodule00, self.GTVmodule01,
                                 self.GLRmodule01)
                     for t in (mod.stats_table(),))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.n_graphs
        ew = edge_weights_chw if self.use_kernels else edge_weights_plain

        f00, f01 = self._heads(x)
        if self.tp is not None:
            # expert split: this rank's G/tp graphs, their code channels and
            # their GTV and GLR feature rows; the solved channels gathered
            from irdu_tpu_torch.parallel.tensor import Placement, gather_full

            tp, c = self.tp, x.shape[1]
            g //= tp.size
            lo, hi = tp.index * g * self.n_node_fts, (tp.index + 1) * g * self.n_node_fts
            x = x[:, lo:hi]
            f00, f01 = (torch.cat([f[:, lo:hi], f[:, c + lo:c + hi]], dim=1) for f in (f00, f01))
            return gather_full(self._solve(x, f00, f01, g, ew), Placement(1), tp)
        return self._solve(x, f00, f01, g, ew)

    def _solve(self, x, f00, f01, g, ew):
        """The unroll of g graphs on the code x and the features of its GTV
        and GLR graphs (f00 at full, f01 at half resolution)."""
        d = self.deltas
        w00 = ew(f00, torch.cat([self.GTVmodule00.multiM, self.GLRmodule00.multiM]),
                 n_graphs=2 * g, deltas=d)
        w01 = ew(f01, torch.cat([self.GTVmodule01.multiM, self.GLRmodule01.multiM]),
                 n_graphs=2 * g, deltas=d)
        weights = (w00[:, :g].contiguous(), w00[:, g:].contiguous(),
                   w01[:, :g].contiguous(), w01[:, g:].contiguous())
        tables = self._tables(g)
        if _mega_ok(x.shape):
            unroll = gg_unroll_chw if self.use_kernels else gg_unroll_plain
            return unroll(x.contiguous(), *weights, *tables, unroll_scal(
                g, *self._positive(), self.alphaCGD, self.betaCGD),
                n_graphs=g, eval_cg_iters=self.eval_cg_iters, deltas=d)
        return self._band_route(x.contiguous(), weights, tables, g)

    def _positive(self):
        """exp of the log-parameters: μ₀, ρ₀, μ₁, ρ₁, γ₀, γ₁ per graph."""
        return tuple(torch.exp(p.float()) for p in (
            self.muys00, self.ro00, self.muys01, self.ro01, self.gamma00, self.gamma01))

    def _band_route(self, y, weights, tables, g):
        """The unroll of g graphs as K5 steps on the window (JAX
        ``_forward_chw``'s band route), each output rounded to y's dtype."""
        step = gg_fused_step_chw if self.use_kernels else fused_step_plain
        wg0, wl0, wg1, wl1 = weights
        pg0, pl0, pg1, pl1 = tables
        mu0, ro0, mu1, ro1, gam0, gam1 = self._positive()

        def gtv_only(x, aux, scal, mode):  # rhs and rethresh read the GTV graphs only
            return step(x, aux, None, wg0, None, wg1, None, pg0, None, pg1, None, scal,
                        mode=mode, n_graphs=g, deltas=self.deltas)

        def cg(x, rhs, prev, i, **kw):
            scal = fused_scal(g, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1,
                              alpha=self.alphaCGD[i],
                              beta=self.betaCGD[i] if prev is not None else None)
            return step(x, rhs, prev, wg0, wl0, wg1, wl1, pg0, pl0, pg1, pl1, scal,
                        mode="cg", n_graphs=g, deltas=self.deltas, **kw)

        # ADMM init RHS, then CG step 1 from x₀ = RHS (so rhs ≡ x)
        rhs_a = gtv_only(y, None, fused_scal(g, ro0=ro0, ro1=ro1), "rhs")
        out01 = cg(rhs_a, None, None, 0, use_x_rhs=True)
        if self.eval_cg_iters == 1:
            return out01
        # ADMM re-threshold and the new RHS, used by CG steps 2 and 3
        rhs_b = gtv_only(out01, y, fused_scal(g, ro0=ro0, ro1=ro1, gamma0=gam0,
                                             gamma1=gam1), "rethresh")
        if self.eval_cg_iters == 2:
            return cg(out01, rhs_b, None, 1)
        out02, upd01 = cg(out01, rhs_b, None, 1, emit_update=True)
        return cg(out02, rhs_b, upd01, 2)  # β[2] momentum; β[1] unused
