"""The flagship's latent two-scale GGTV+GGLR unrolled ADMM/CG solver
(counterpart: ``irdu_tpu/solvers/gtv_glr.py`` ``MixtureGTVGLR``, the route
``_forward_chw`` takes for planes the whole-unroll kernel covers).

Channels-first (B, C, H, W) with C = G·F; H and W even. Per call: the two
feature heads, K2 once per scale with the GTV and GLR graphs batched as 2G
graphs, then K1 over the whole unroll. The reference quirks the unroll keeps
are listed in ``ops/solver_unroll.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irdu_tpu_torch.models.layers import Downsample2x2, GroupedPointwise
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain, unroll_scal
from irdu_tpu_torch.solvers.common import GraphOpParams

N_CGD_ITERS = 3  # fixed in the reference


class MixtureGTVGLR(nn.Module):
    """A CPU tensor takes the kernels' plain versions and a CUDA tensor the
    kernels. Setting the attribute ``use_kernels`` to False runs the plain
    versions on any device: the on-card reference the kernel path is held to."""

    def __init__(self, n_graphs: int, n_node_fts: int, *, eval_cg_iters: int = 3):
        super().__init__()
        g, f = n_graphs, n_node_fts
        c = g * f
        self.n_graphs, self.n_node_fts = g, f
        self.eval_cg_iters = eval_cg_iters
        self.use_kernels = True
        self.alphaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), 0.5))
        self.betaCGD = nn.Parameter(torch.full((N_CGD_ITERS, g), 0.1))
        # full-res head 1×1 C→2C; half-res head 2×2 stride-2 C→C then 1×1 C→2C
        self.patchs_features_extraction00 = GroupedPointwise(c, 2 * c)
        self.patchs_features_extraction01_down = Downsample2x2(c, c)
        self.patchs_features_extraction01_point = GroupedPointwise(c, 2 * c)
        # log-parameterized positive weights, at the flagship's initial values
        for name, v in (("ro00", 1e-4), ("ro01", 1e-4), ("gamma00", 1e-4),
                        ("gamma01", 1e-4), ("muys00", 1e-3), ("muys01", 1e-4)):
            setattr(self, name, nn.Parameter(torch.full((g,), math.log(v))))
        self.GTVmodule00 = GraphOpParams(g, f)
        self.GLRmodule00 = GraphOpParams(g, f)
        self.GTVmodule01 = GraphOpParams(g, f)
        self.GLRmodule01 = GraphOpParams(g, f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.n_graphs
        ew = edge_weights_chw if self.use_kernels else edge_weights_plain
        unroll = gg_unroll_chw if self.use_kernels else gg_unroll_plain

        f00 = self.patchs_features_extraction00(x)
        f01 = self.patchs_features_extraction01_point(
            self.patchs_features_extraction01_down(x))
        w00 = ew(f00, torch.cat([self.GTVmodule00.multiM, self.GLRmodule00.multiM]),
                 n_graphs=2 * g)
        w01 = ew(f01, torch.cat([self.GTVmodule01.multiM, self.GLRmodule01.multiM]),
                 n_graphs=2 * g)

        def exp(p):
            return torch.exp(p.float())

        scal = unroll_scal(g, exp(self.muys00), exp(self.ro00), exp(self.muys01),
                           exp(self.ro01), exp(self.gamma00), exp(self.gamma01),
                           self.alphaCGD, self.betaCGD)
        return unroll(
            x.contiguous(), w00[:, :g].contiguous(), w00[:, g:].contiguous(),
            w01[:, :g].contiguous(), w01[:, g:].contiguous(),
            self.GTVmodule00.stats_table(), self.GLRmodule00.stats_table(),
            self.GTVmodule01.stats_table(), self.GLRmodule01.stats_table(), scal,
            n_graphs=g, eval_cg_iters=self.eval_cg_iters)
