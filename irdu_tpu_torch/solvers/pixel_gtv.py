"""The pixel-domain mixture GTV+GLR solver (counterpart:
``irdu_tpu/solvers/pixel_gtv.py`` ``MixtureGTV``).

The 3-channel image is replicated across G mixture hypotheses; a
Restormer-style FFBlock U-Net gives the edge-weight features (G·F channels)
and 12 DC channels; the DC estimator takes the DC term off the image (ỹ); the
unroll (``ops/pixel_unroll.py``: 2 ADMM rounds × 2 CG steps, one scale, the
graph window, diamond-12 by default, cross-4 or ring-8; scalar stencils
with the reflect pad) filters ỹ on every graph; a learned softmax score over
the graphs combines the hypotheses and the DC term is added back. With
``eval_skip_solve`` (JAX's accounting probe) the unroll is skipped: the
score combines G copies of ỹ, and no solver kernel launches. Channels-first
(B, 3, H, W), H and W multiples of 4 (the feature U-Net).

Three routes, chosen per call by JAX's flags and in JAX's precedence (with
the attribute ``use_kernels`` False, ``registry.set_kernels``' switch, the
plain route whatever the flags say):

  NHWC  (``use_nhwc_unroll``): K2 once on 2G stacked graphs (the same
        features under the GTV and the GLR metric), its weights packed
        channels-last, then 6 K8 segments (``ops/pixel_nhwc.py``) in planar
        channel order c = f·G + g;
  CHW   (``use_pallas_unroll``): the same K2 call, then in interleaved
        order c = g·F + f K7 once (``ops/pixel_unroll.py``) for
        H·W ≤ ``gtv_glr._MEGA_MAX_PIXELS``, and above it the band route: ỹ
        tiled G times and 6 single-scale K5 steps (``ops/fused_step.py``,
        the window, reflect pad): rhs; cg from x as its rhs, emitting the
        update; cg with β·prev; rethresh with y; cg emitting the update; cg
        with β·prev (JAX ``_forward_chw``);
  plain (neither): the same unroll in plain PyTorch (the JAX jnp path), on
        any device; the on-card reference the kernel routes are held to.

With ``stats_mode="none"`` (the v4 core: no stencil) every route runs as
with the scalar stencil, the stencil the identity: K7 and K5 take None
tables as the table [1, 0, 0, 0], K8 those four scalars, and s = 1·v +
0·(…) is v exactly. JAX sends this core to its jnp path, since its fused
kernels read the scalar stencil's parameters; the arithmetic is the same.

JAX computes the NHWC route's weights outside its kernels; the port has K2
for them. JAX's ``_nhwc_ok`` and ``_chw_ok`` also ask H % 16 == 0 (NHWC),
H % 8 == 0 (CHW) and W % 128 == 0: TPU band and lane rules the port does
not copy, since its kernels take any H and W. Where they fail JAX falls
back (to its CHW route or its jnp path) and the port keeps the kernel route
its flags name, with the same arithmetic.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irdu_tpu_torch.models.layers import GroupedPointwise, remat_call
from irdu_tpu_torch.models.restormer_blocks import FeatureExtraction, GatedDConvBlock
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.fused_step import fused_scal, gg_fused_step_chw
from irdu_tpu_torch.ops.graph import at_least_f32, pack_edge_weights
from irdu_tpu_torch.ops.pixel_nhwc import pixel_unroll_nhwc
from irdu_tpu_torch.ops.pixel_unroll import (gg_pixel_unroll_chw, pixel_unroll_plain,
                                             pixel_unroll_scal)
from irdu_tpu_torch.ops.windows import WINDOWS
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.solvers.common import GraphOpParams

N_DC_CHANNELS = 12
N_CGD_ITERS = 4  # fixed in the reference: 2 ADMM rounds of 2 CG steps
FFN_EXPANSION = 2.6666  # the feature U-Net's hidden widths: 191, 383, 767 at dim 72


class MixtureGTV(nn.Module):
    """The image's F = 3 colour channels are the graphs' node features; the
    graphs' ``window`` is "diamond12" (the family's configs), "cross4" or
    "ring8", on every route."""

    def __init__(self, n_graphs: int = 24, n_node_fts: int = 3, n_cnn_fts: int = 72,
                 feature_num_blocks=(2, 3, 3, 4), feature_num_refinement: int = 4,
                 use_pallas_unroll: bool = False, use_nhwc_unroll: bool = False,
                 muy_init: float = 0.1, ro_init: float = 0.1, gamma_init: float = 1e-3,
                 stats_mode: str = "scalar", feature_n_levels: int = 3, remat: bool = False,
                 window: str = "diamond12", eval_skip_solve: bool = False):
        """``remat``: the plain route's unroll recomputed in the backward
        pass segment by segment (the edge weights, the first RHS, each CG
        round, the re-threshold's RHS: ``_unroll_plain``), and the feature
        U-Net's FFBlocks (its own attribute), as JAX's ``remat`` does.
        ``eval_skip_solve``: JAX's accounting probe, the forward without the
        unroll (``forward``); built with it, the solver has no graph
        operators (``GTVmodule00``, ``GLRmodule00``), as JAX's parameter
        tree has none. The attribute can be set on a built solver too."""
        super().__init__()
        if stats_mode not in ("scalar", "none"):
            raise ValueError(f"stats_mode must be 'scalar' or 'none', got {stats_mode!r}")
        g, f = n_graphs, n_node_fts
        self.n_graphs, self.n_node_fts = g, f
        self.deltas = WINDOWS[window]
        self.eval_skip_solve = eval_skip_solve
        self.use_pallas_unroll = use_pallas_unroll
        self.use_nhwc_unroll = use_nhwc_unroll
        self.use_kernels = True
        self.remat = remat
        self.alphaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), 0.5))
        self.betaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), 0.1))
        self.patchs_features_extraction = FeatureExtraction(
            f, g * f + N_DC_CHANNELS, n_cnn_fts, feature_num_blocks,
            feature_num_refinement, FFN_EXPANSION, n_levels=feature_n_levels, remat=remat)
        self.combination_weight = GroupedPointwise(g * f, g)
        self.dc_estimator = GatedDConvBlock(N_DC_CHANNELS, f, 2 * N_DC_CHANNELS)
        # raw μ and ρ, log γ
        self.ro00 = nn.Parameter(torch.full((g,), float(ro_init)))
        self.muys00 = nn.Parameter(torch.full((g,), float(muy_init)))
        self.gamma00 = nn.Parameter(torch.full((g,), math.log(gamma_init)))
        if not eval_skip_solve:  # JAX creates the graph operators only where the unroll runs
            self.GTVmodule00 = GraphOpParams(g, f, stats_mode=stats_mode)
            self.GLRmodule00 = GraphOpParams(g, f, stats_mode=stats_mode)

    def route(self) -> str:
        """"nhwc", "chw" or "plain", from ``use_kernels`` and the flags
        alone: every route takes any H and W."""
        if not self.use_kernels:
            return "plain"
        if self.use_nhwc_unroll:
            return "nhwc"
        return "chw" if self.use_pallas_unroll else "plain"

    def forward(self, patchs: torch.Tensor) -> torch.Tensor:
        g, f = self.n_graphs, self.n_node_fts
        feats = self.patchs_features_extraction(patchs)
        ew = feats[:, :g * f]
        dc_term = self.dc_estimator(feats[:, g * f:])
        y_tilde = patchs - dc_term
        if self.eval_skip_solve:  # JAX's probe: the score over G copies of ỹ, no unroll
            score = torch.softmax(self.combination_weight(ew), dim=1).to(y_tilde.dtype)
            return (y_tilde[:, None] * score[:, :, None]).sum(dim=1) + dc_term
        route = self.route()
        if route == "nhwc":
            out = self._unroll_nhwc(ew, y_tilde)
        else:
            if route == "chw":
                out = self._unroll_chw(ew, y_tilde)
            else:
                out = self._unroll_plain(ew, y_tilde,
                                         remat=self.remat and torch.is_grad_enabled())
            b, _, h, w = out.shape
            out = out.reshape(b, g, f, h, w)  # channel g·F + f
        # the mixture: a softmax score over the graphs
        score = torch.softmax(self.combination_weight(ew), dim=1).to(out.dtype)
        return (out * score[:, :, None]).sum(dim=1) + dc_term

    def _scal(self):
        return pixel_unroll_scal(self.n_graphs, self.muys00, self.ro00,
                                 torch.exp(at_least_f32(self.gamma00)),
                                 at_least_f32(self.alphaCGD), at_least_f32(self.betaCGD))

    def _unroll_plain(self, ew, y_tilde, remat=False):
        """JAX's jnp path: each operator's weights, then the unroll on the
        plain versions. ``remat``: JAX's segments (both operators' weights,
        the first RHS, each CG round, the re-threshold's RHS) each recomputed
        in the backward pass."""
        g, d = self.n_graphs, self.deltas

        def edge_weights(ew):
            return (edge_weights_plain(ew, self.GTVmodule00.multiM, g, d),
                    edge_weights_plain(ew, self.GLRmodule00.multiM, g, d))

        w_gtv, w_glr = remat_call(edge_weights, ew, remat)
        return pixel_unroll_plain(
            y_tilde, w_gtv, w_glr, self.GTVmodule00.stats_table(),
            self.GLRmodule00.stats_table(), self._scal(), n_graphs=g, deltas=d, remat=remat)

    def _edge_weights(self, ew):
        """Both operators' weights from one K2 call on 2G stacked graphs:
        (B, 2G, E, H, W), the GTV graphs first."""
        ew = ew.contiguous()
        return edge_weights_chw(
            torch.cat([ew, ew], dim=1),
            torch.cat([self.GTVmodule00.multiM, self.GLRmodule00.multiM]),
            n_graphs=2 * self.n_graphs, deltas=self.deltas)

    def _unroll_chw(self, ew, y_tilde):
        """K2, then K7, or above ``_MEGA_MAX_PIXELS`` the K5 band route (JAX
        ``_forward_chw``). Returns (B, G·F, H, W), channel g·F + f."""
        g, d = self.n_graphs, self.deltas
        h, w = y_tilde.shape[-2:]
        w_all = self._edge_weights(ew)
        w_gtv, w_glr = w_all[:, :g].contiguous(), w_all[:, g:].contiguous()
        tables = (self.GTVmodule00.stats_table(), self.GLRmodule00.stats_table())
        if h * w <= gtv_glr._MEGA_MAX_PIXELS:
            return gg_pixel_unroll_chw(y_tilde.contiguous(), w_gtv, w_glr, *tables,
                                       self._scal(), n_graphs=g, deltas=d)
        return self._band_route(y_tilde.repeat(1, g, 1, 1), w_gtv, w_glr, tables)

    def _band_route(self, y, w_gtv, w_glr, tables):
        """The unroll as 6 single-scale K5 calls on the tiled ỹ
        (B, G·F, H, W), each output rounded to y's dtype."""
        g = self.n_graphs
        pgtv, pglr = tables
        mu, ro = self.muys00.float(), self.ro00.float()
        alpha, beta = self.alphaCGD.float(), self.betaCGD.float()

        def run(x, aux, prev, glr, scal, mode, **kw):
            return gg_fused_step_chw(x, aux, prev, w_gtv, w_glr if glr else None, None, None,
                                     pgtv, pglr if glr else None, None, None, scal, mode=mode,
                                     n_graphs=g, deltas=self.deltas, stats_mode="reflect", **kw)

        def cg_round(rhs, i):  # CG restarted from x₀ = rhs: steps i and i + 1
            out, upd = run(rhs, None, None, True, fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[i]),
                           "cg", use_x_rhs=True, emit_update=True)
            return run(out, rhs, upd, True, fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[i + 1],
                                                       beta=beta[i + 1]), "cg")

        rhs = run(y, None, None, False, fused_scal(g, ro0=ro), "rhs")  # bias 0
        out = cg_round(rhs, 0)
        # the ADMM re-threshold (bias 0, so ε − bias = 2·S_γ(Cx) − Cx), then round 2
        rhs = run(out, y, None, False, fused_scal(g, ro0=ro, gamma0=torch.exp(
            self.gamma00.float())), "rethresh")
        return cg_round(rhs, 2)

    def _unroll_nhwc(self, ew, y_tilde):
        """K2, the weights packed, then 6 K8 segments (JAX ``_forward_nhwc``).
        Returns (B, G, F, H, W)."""
        g, f, d = self.n_graphs, self.n_node_fts, self.deltas
        w_all = self._edge_weights(ew)
        w_gtv, w_glr = pack_edge_weights(w_all[:, :g]), pack_edge_weights(w_all[:, g:])
        # planar ỹ: channel c = f·G + g, each image channel repeated G times
        y72 = y_tilde.permute(0, 2, 3, 1).repeat_interleave(g, dim=-1).contiguous()
        p = torch.stack([self.GTVmodule00.stats_scalars(), self.GLRmodule00.stats_scalars()])
        scal = {"mu": self.muys00.float().repeat(f), "ro": self.ro00.float().repeat(f),
                "gamma": torch.exp(self.gamma00.float()).repeat(f),
                "alpha": self.alphaCGD.float().repeat(1, f),
                "beta": self.betaCGD.float().repeat(1, f)}
        out = pixel_unroll_nhwc(y72, w_gtv, w_glr, p, scal, n_graphs=g, deltas=d)
        b, h, w, _ = out.shape
        return out.reshape(b, h, w, f, g).permute(0, 4, 3, 1, 2)  # (B, G, F, H, W)
