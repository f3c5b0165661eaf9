"""The single-scale GTV+GLR and GLR-only solvers of the ablation studies
(counterpart: ``irdu_tpu/solvers/ablation_solvers.py``), channels-first.

The reference quirks the port keeps:

  * one spatial scale; the feature head is 3 stacked LocalNonLinearBlocks
    (hidden ``int(C·8/3)``) and a 1×1 expand, and the GLR-only head has no
    expand (JAX ``ablation_solvers.py:55-56``);
  * the stencil is off (``stats_mode="none"``): the identity;
  * β[1] IS used (update01 = res01 + β[1]·res00, JAX :134-135), unlike
    the flagship;
  * the split variant feeds the first half of the input channels to the GTV
    head and the second half to the GLR head.

On the card the heads' blocks run through the block kernels as the
flagship routes them (``models/flagship.run_blocks``: K3 for C ≤ 64, K4
above; JAX serves this family on jnp), the edge weights through one K2 call
on the 2G stacked GTV+GLR graphs (G graphs for GLR only), and
``GTVGLRSingleScale``'s three system matvecs, on the cross-4 window, through
K9 (``ops/system_matvec.py``, channels-last: each call permutes the iterate
to (B, H, W, C) and back; the weights are laid out once per forward). On
the diamond-12 and ring-8 windows, which K9 is not built for, the three
matvecs go to K6a (``ops/fused_step.gg_matvec_chw``: single-scale launches
of K5's padded-tile kernel on the window, channels-first like the iterate,
so no permutes; the stats tables set to None go in as the identity). The
other steps (the ADMM RHS builds, the CG updates, and GLRSingleScale's
matvec, which has no Pallas kernel in JAX) are PyTorch ops in f32 on the
model's values, each iterate rounded to the model's dtype. Setting the
attribute ``use_kernels`` to False runs the plain versions on any device: the
on-card reference the kernel path is held to.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irdu_tpu_torch.models.blocks import LocalNonLinearBlock
from irdu_tpu_torch.models.flagship import run_blocks
from irdu_tpu_torch.models.layers import GroupedPointwise
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.fused_step import gg_matvec_chw, matvec_plain
from irdu_tpu_torch.ops.system_matvec import fused_system_matvec, system_matvec_plain
from irdu_tpu_torch.ops.windows import CROSS4, WINDOWS
from irdu_tpu_torch.solvers.common import GraphOpParams


class _NonLinearHead(nn.Module):
    """3 LocalNonLinearBlocks of hidden width int(C·8/3), then an optional 1×1
    expand C → out_channels (JAX ``_NonLinearHead``)."""

    def __init__(self, channels: int, out_channels: int, with_expand: bool = True):
        super().__init__()
        hidden = int(channels * 8 / 3)
        self.blocks = [LocalNonLinearBlock(channels, hidden) for _ in range(3)]
        for i, block in enumerate(self.blocks):
            self.add_module(f"block_{i}", block)
        self.expand = GroupedPointwise(channels, out_channels) if with_expand else None
        self.use_kernels = True

    def forward(self, x):
        x = run_blocks(x, self.blocks, self.use_kernels)
        return x if self.expand is None else self.expand(x)


def _log_param(shape, value):
    return nn.Parameter(torch.full(shape, math.log(value)))


class _SingleScale(nn.Module):
    """What both solvers share: the CG tables α, β (n_cgd_iters, G), the log
    μ, and the GLR operator's parameters."""

    def __init__(self, n_graphs, n_node_fts, alpha_init, beta_init, muy_init, window,
                 stats_mode, n_cgd_iters):
        super().__init__()
        g = n_graphs
        self.n_graphs, self.n_node_fts = g, n_node_fts
        self.deltas = WINDOWS[window]
        self.use_kernels = True
        self.alphaCGD = nn.Parameter(torch.full((n_cgd_iters, g), float(alpha_init)))
        self.betaCGD = nn.Parameter(torch.full((n_cgd_iters, g), float(beta_init)))
        self.muys00 = _log_param((g,), muy_init)
        self.GLRmodule00 = GraphOpParams(g, n_node_fts, stats_mode=stats_mode)

    def _edge_weights(self, feats, mods):
        """K2 (or its plain version) on the graphs of ``mods`` stacked in
        order: feats (B, len(mods)·G·F, H, W) → (B, len(mods)·G, E, H, W)."""
        m = torch.cat([mod.multiM for mod in mods])
        if self.use_kernels:
            return edge_weights_chw(feats.contiguous(), m, n_graphs=m.shape[0],
                                    deltas=self.deltas)
        return edge_weights_plain(feats, m, m.shape[0], self.deltas)

    def _per_graph(self, v):  # (G,) → (G, 1, 1, 1) f32, broadcast over (B, G, F, H, W)
        return v.float().reshape(self.n_graphs, 1, 1, 1)

    def _cg(self, i, table):  # α[i] or β[i] per graph
        return self._per_graph(table[i])

    def _views(self, x):  # (B, C, H, W) → (B, G, F, H, W) f32
        b, c, h, w = x.shape
        return x.float().reshape(b, self.n_graphs, c // self.n_graphs, h, w)

    @staticmethod
    def _edges(w):  # (B, G, E, H, W) → E × (B, G, 1, H, W) f32
        w = w.float()
        return [w[:, :, e:e + 1] for e in range(w.shape[2])]


class GTVGLRSingleScale(_SingleScale):
    """Single-scale GTV+GLR unroll (ablation ``GTVGLR``): the ADMM init RHS,
    CG step 1, the re-threshold RHS, CG steps 2 and 3 with β momentum."""

    def __init__(self, n_graphs: int, n_node_fts: int, alpha_init: float = 0.5,
                 beta_init: float = 0.1, muy_init: float = 0.001, ro_init: float = 1e-6,
                 gamma_init: float = 1e-6, window: str = "cross4", stats_mode: str = "none",
                 split_heads: bool = False, n_cgd_iters: int = 3):
        super().__init__(n_graphs, n_node_fts, alpha_init, beta_init, muy_init, window,
                         stats_mode, n_cgd_iters)
        g = n_graphs
        c = g * n_node_fts
        self.split_heads = split_heads
        if split_heads:
            self.patchs_features_extractionGLR = _NonLinearHead(c // 2, c)
            self.patchs_features_extractionGTV = _NonLinearHead(c // 2, c)
        else:
            self.patchs_features_extraction00 = _NonLinearHead(c, 2 * c)
        self.ro00 = _log_param((g,), ro_init)
        self.gamma00 = _log_param((g,), gamma_init)
        self.GTVmodule00 = GraphOpParams(g, n_node_fts, stats_mode=stats_mode)

    def _rows(self, mod):
        """The stencil as K9's (4, C) rows, or None."""
        tab = mod.stats_table()
        return None if tab is None else tab.permute(1, 0, 2).reshape(4, -1)

    def _k9_matvec(self, w_glr, w_gtv):
        """The system matvec of a (B, C, H, W) iterate (f32 view out) on K9,
        cross-4, channels-last; the weights laid out as (B, H, W, G, E) once
        for the three calls."""
        g, f = self.n_graphs, self.n_node_fts
        w_nhwc = [w.permute(0, 3, 4, 1, 2).contiguous() for w in (w_glr, w_gtv)]
        rows = (self._rows(self.GLRmodule00), self._rows(self.GTVmodule00))
        mu_c, ro_c = (torch.exp(p.float()).repeat_interleave(f)
                      for p in (self.muys00, self.ro00))
        matvec = fused_system_matvec if self.use_kernels else system_matvec_plain

        def a_x(x):
            out = matvec(x.permute(0, 2, 3, 1).contiguous(), *w_nhwc, *rows, mu_c, ro_c,
                         n_graphs=g)
            return self._views(out.permute(0, 3, 1, 2))

        return a_x

    def _k6a_matvec(self, w_glr, w_gtv):
        """The same on K6a, on the solver's window (diamond-12 or ring-8),
        channels-first; the weights in the iterate's dtype, once."""
        wl, wg = (w.contiguous() for w in (w_glr, w_gtv))
        tabs = (self.GLRmodule00.stats_table(), self.GTVmodule00.stats_table())
        mu, ro = torch.exp(self.muys00.float()), torch.exp(self.ro00.float())
        matvec = gg_matvec_chw if self.use_kernels else matvec_plain

        def a_x(x):
            return self._views(matvec(x.contiguous(), wl.to(x.dtype), wg.to(x.dtype), *tabs,
                                      mu, ro, n_graphs=self.n_graphs, deltas=self.deltas))

        return a_x

    def forward(self, patchs: torch.Tensor) -> torch.Tensor:
        g, f = self.n_graphs, self.n_node_fts
        dt = patchs.dtype
        if self.split_heads:
            f_gtv_in, f_glr_in = patchs.chunk(2, dim=1)
            feats = torch.cat([self.patchs_features_extractionGTV(f_gtv_in),
                               self.patchs_features_extractionGLR(f_glr_in)], dim=1)
        else:
            feats = self.patchs_features_extraction00(patchs)  # GTV features, then GLR
        w_all = self._edge_weights(feats, (self.GTVmodule00, self.GLRmodule00))
        w_gtv = w_all[:, :g]
        a_x = (self._k9_matvec if self.deltas == CROSS4 else self._k6a_matvec)(
            w_all[:, g:], w_gtv)

        wg, pg = self._edges(w_gtv), graph.stats_table_terms(self.GTVmodule00.stats_table())
        ro = self._per_graph(torch.exp(self.ro00.float()))
        gamma = self._per_graph(torch.exp(self.gamma00.float()))
        alpha = lambda i: self._cg(i, self.alphaCGD)  # noqa: E731
        beta = lambda i: self._cg(i, self.betaCGD)  # noqa: E731

        def iterate(v):  # (B, G, F, H, W) f32 → (B, C, H, W) in the model's dtype
            return v.reshape(patchs.shape).to(dt)

        y = self._views(patchs)
        rhs_a = y + ro * graph.gtv_apply(y, wg, pg, self.deltas)
        out00 = iterate(rhs_a)
        res00 = rhs_a - a_x(out00)
        out01 = iterate(self._views(out00) + alpha(0) * res00)
        rhs_b = y + ro * graph.gtv_rethresh_apply(self._views(out01), wg, pg, gamma,
                                                  self.deltas)
        update01 = rhs_b - a_x(out01) + beta(1) * res00  # β[1] is used in this lineage
        out02 = iterate(self._views(out01) + alpha(1) * update01)
        update03 = rhs_b - a_x(out02) + beta(2) * update01
        return iterate(self._views(out02) + alpha(2) * update03)


class GLRSingleScale(_SingleScale):
    """GLR-only 3-step CG unroll, no ADMM (ablation ``GLR``): RHS = y."""

    def __init__(self, n_graphs: int, n_node_fts: int, alpha_init: float = 0.5,
                 beta_init: float = 0.1, muy_init: float = 0.001, window: str = "cross4",
                 stats_mode: str = "none", n_cgd_iters: int = 3):
        super().__init__(n_graphs, n_node_fts, alpha_init, beta_init, muy_init, window,
                         stats_mode, n_cgd_iters)
        c = n_graphs * n_node_fts
        self.patchs_features_extraction00 = _NonLinearHead(c, c, with_expand=False)

    def forward(self, patchs: torch.Tensor) -> torch.Tensor:
        dt = patchs.dtype
        w_glr = self._edges(self._edge_weights(self.patchs_features_extraction00(patchs),
                                               (self.GLRmodule00,)))
        pl = graph.stats_table_terms(self.GLRmodule00.stats_table())
        mu = self._per_graph(torch.exp(self.muys00.float()))
        alpha = lambda i: self._cg(i, self.alphaCGD)  # noqa: E731
        beta = lambda i: self._cg(i, self.betaCGD)  # noqa: E731

        def res(x):  # y − A·x of a (B, C, H, W) iterate, A = I + μ·GLR, f32
            xv = self._views(x)
            return y - (xv + mu * graph.glr_apply(xv, w_glr, pl, self.deltas))

        def iterate(v):  # (B, G, F, H, W) f32 → (B, C, H, W) in the model's dtype
            return v.reshape(patchs.shape).to(dt)

        y = self._views(patchs)
        res00 = res(patchs)
        out01 = iterate(y + alpha(0) * res00)
        update01 = res(out01) + beta(1) * res00
        out02 = iterate(self._views(out01) + alpha(1) * update01)
        update02 = res(out02) + beta(2) * update01
        return iterate(self._views(out02) + alpha(2) * update02)
