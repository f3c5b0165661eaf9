"""Multiscale GLR boosting pyramid, channels-first inside, NHWC (B, H, W, 3)
at the model boundary (counterpart: ``irdu_tpu/models/glr_boosting.py``).

A 3×3 embedding and 3 LocalNonLinearBlocks take the image to a 12-channel
abstract signal; a box pyramid of it (4 levels) is boosted from the coarsest
level up: each level solves (I + μ_k L_k) x = r_k for the current residual
with an unrolled conjugate-gradient whose step sizes are learned per
iteration and graph, over G = 5 graphs on the ring-8 window, and mixes the
G solutions by a softmax of a learned per-graph score of its features.
H and W must be multiples of 2^(levels − 1).

The level's edge weights are K2 (``ops.edge_weights.edge_weights_chw``) on
the card and its plain version on the CPU, or on any device with
``use_kernels`` off (the differentiable route training takes); JAX computes
them on jnp. The blocks, the Laplacian matvec and the mixture are PyTorch
ops. Module names mirror the flax scopes (``level_k/extractor/layers_0``
…), so ``utils.weights.params_to_torch`` lands a JAX snapshot on them.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from irdu_tpu_torch.models.blocks import LocalNonLinearBlock, RegionalPixelEmbedding
from irdu_tpu_torch.models.layers import GroupedPointwise
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.graph import box_down2x2, box_up2x2, op_l_norm, per_graph_scale
from irdu_tpu_torch.ops.windows import WINDOWS
from irdu_tpu_torch.solvers.common import GraphOpParams


class _LevelGLRSolver(nn.Module):
    """One pyramid level: edge features from the residual (B, c, H, W), then
    an unrolled CG on (I + μL)x = r over G graphs, the graphs' solutions
    mixed by a softmax over G of a learned score of their features."""

    def __init__(self, c_in: int, n_graphs: int, n_node_fts: int, n_features: int,
                 muy_init: float, n_cgd_iters: int = 5, alpha_init: float = 0.5,
                 beta_init: float = 0.1, window: str = "ring8"):
        super().__init__()
        g, f = n_graphs, n_node_fts
        self.n_graphs, self.n_node_fts = g, f
        self.deltas = WINDOWS[window]
        self.use_kernels = True
        self.alphaCGD = nn.Parameter(torch.full((n_cgd_iters, g), alpha_init))
        self.betaCGD = nn.Parameter(torch.full((n_cgd_iters, g), beta_init))
        self.muys = nn.Parameter(torch.full((g,), math.log(muy_init)))
        self.GLRmodule = GraphOpParams(g, f, stats_mode="none")
        # flax's nn.Sequential names its layers layers_0, layers_1
        self.extractor = nn.Sequential(OrderedDict(
            layers_0=LocalNonLinearBlock(n_features, n_features * 2),
            layers_1=GroupedPointwise(n_features, g * f)))
        self.feat_in = GroupedPointwise(c_in, n_features)
        self.combine = GroupedPointwise(f, 1)  # (F, 1), shared by the graphs

    def edge_weights(self, feats: torch.Tensor) -> torch.Tensor:
        m = self.GLRmodule.multiM
        if self.use_kernels:
            return edge_weights_chw(feats.contiguous(), m, n_graphs=self.n_graphs,
                                    deltas=self.deltas)
        return edge_weights_plain(feats, m, self.n_graphs, self.deltas)

    def forward(self, residual: torch.Tensor) -> torch.Tensor:
        b, c, h, w = residual.shape
        g = self.n_graphs
        feats = self.extractor(self.feat_in(residual))  # (B, G·F, H, W)
        weights = self.edge_weights(feats)  # (B, G, E, H, W)
        mu = torch.exp(self.muys)

        def per_channel(v):  # (G,) repeated c times a graph, graph-major
            return v.repeat_interleave(c)[None, :, None, None]

        y = residual.repeat(1, g, 1, 1)  # the residual tiled G times, graph-major
        out, update = y, None
        for i in range(self.alphaCGD.shape[0]):
            res = y - (out + per_graph_scale(op_l_norm(out, weights, g, self.deltas), mu))
            update = res if update is None else res + per_channel(self.betaCGD[i]) * update
            out = out + per_channel(self.alphaCGD[i]) * update
        score = self.combine(feats.reshape(b * g, self.n_node_fts, h, w)).reshape(b, g, h, w)
        score = torch.softmax(score, dim=1)  # max-subtracted, over the graphs
        return torch.sum(out.reshape(b, g, c, h, w) * score[:, :, None], dim=1)


class GLRBoostingPyramid(nn.Module):
    """Coarse-to-fine multiscale GLR boosting denoiser."""

    def __init__(self, n_channels_in: int = 3, n_channels_out: int = 3,
                 nchannels_abstract: int = 12, n_blocks: int = 3, n_graphs: int = 5,
                 n_levels: int = 4, n_cgd_iters: int = 5,
                 muy_init: Sequence[float] = (0.3, 0.15, 0.075, 0.0375),
                 node_fts: Sequence[int] = (12, 12, 24, 48),
                 level_features: Sequence[int] = (60, 60, 120, 240), window: str = "ring8"):
        super().__init__()
        ca = nchannels_abstract
        self.n_blocks, self.n_levels = n_blocks, n_levels
        self.abstract_embed = RegionalPixelEmbedding(n_channels_in, ca)
        for i in range(n_blocks):
            setattr(self, f"embed_block_{i}", LocalNonLinearBlock(ca, ca * 2))
        for k in range(n_levels):
            setattr(self, f"level_{k}", _LevelGLRSolver(
                ca, n_graphs, node_fts[k], level_features[min(k, len(level_features) - 1)],
                muy_init[k], n_cgd_iters=n_cgd_iters, window=window))
        self.project_out = GroupedPointwise(ca, n_channels_out)

    def graph_frame_recalibrate(self, height: int, width: int) -> None:
        """API parity with the reference notebook: nothing is cached per
        frame size here, so there is nothing to rebuild (a no-op, as in
        JAX)."""

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[1:3]
        if h % (1 << (self.n_levels - 1)) or w % (1 << (self.n_levels - 1)):
            raise ValueError(f"GLR boosting needs H and W multiples of "
                             f"{1 << (self.n_levels - 1)}, got {h}x{w}")
        z = self.abstract_embed(img.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            z = getattr(self, f"embed_block_{i}")(z)
        pyramid = [z]  # the abstract signal's box pyramid
        for _ in range(self.n_levels - 1):
            pyramid.append(box_down2x2(pyramid[-1]))
        est = torch.zeros_like(pyramid[-1])
        for k in range(self.n_levels - 1, -1, -1):
            est = est + getattr(self, f"level_{k}")(pyramid[k] - est)
            if k > 0:  # 4·box_up undoes box_up's 0.25: a nearest-neighbour upsample
                est = 4.0 * box_up2x2(est)
        return self.project_out(est).permute(0, 2, 3, 1)
