"""Encoder/decoder blocks of the flagship LGU model, channels-first
(counterpart: ``irdu_tpu/models/blocks.py``, "plain" variant, one subnet)."""

from __future__ import annotations

import torch
from torch import nn

from irdu_tpu_torch.models.layers import Conv3x3Replicate, GroupedPointwise, uniform_param
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR


class CustomLayerNorm(nn.Module):
    """Per-pixel variance normalization over channels with a learned
    per-channel scale: ``x / sqrt(var + 1e-5) * scale``, the variance unbiased
    (ddof=1). The mean is NOT subtracted from the output."""

    def __init__(self, nchannels: int):
        super().__init__()
        self.weighted_transform = uniform_param((nchannels,), 1)

    def forward(self, x):
        c = x.shape[1]
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).sum(dim=1, keepdim=True) / (c - 1)
        return x / torch.sqrt(var + 1e-5) * self.weighted_transform[None, :, None, None]


class LocalGatedLinearBlock(nn.Module):
    """1×1 expand → 3×3 depthwise (replicate pad) → gate σ(m)·m·u → 1×1 project."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        h2 = 2 * hidden_dim
        self.channels_linear_op = GroupedPointwise(dim, h2)
        self.channels_local_linear_op = Conv3x3Replicate(h2, h2, groups=h2)
        self.project_out = GroupedPointwise(hidden_dim, dim)

    def forward(self, x):
        x = self.channels_local_linear_op(self.channels_linear_op(x))
        mask, u = x.chunk(2, dim=1)
        return self.project_out(torch.sigmoid(mask) * mask * u)


class LocalNonLinearBlock(nn.Module):
    """norm → gated block, with a learned 2-way skip."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.skip_weight = nn.Parameter(torch.ones(2))
        self.norm = CustomLayerNorm(dim)
        self.local_linear = LocalGatedLinearBlock(dim, hidden_dim)

    def gated_params(self) -> dict:
        """The block kernels' operands, views of this block's parameters in
        the JAX layouts: scale (C,), w1 (C, 2H), dwk (3, 3, 2H), w2 (H, C),
        skip (2,)."""
        ll = self.local_linear
        return dict(scale=self.norm.weighted_transform,
                    w1=ll.channels_linear_op.weight[:, :, 0, 0].t(),
                    dwk=ll.channels_local_linear_op.weight[:, 0].permute(1, 2, 0),
                    w2=ll.project_out.weight[:, :, 0, 0].t(),
                    skip=self.skip_weight)

    def forward(self, x):
        sw = self.skip_weight
        return sw[0] * x + sw[1] * self.local_linear(self.norm(x))


class RegionalPixelEmbedding(nn.Module):
    """3×3 replicate-pad patch embedding."""

    def __init__(self, c_in: int, dim: int):
        super().__init__()
        self.channels_local_linear_op01 = Conv3x3Replicate(c_in, dim)

    def forward(self, x):
        return self.channels_local_linear_op01(x)


class LocalLowpassFilteringBlock(nn.Module):
    """One unrolled GGTV+GGLR solve with a learned 0.5/0.5 skip."""

    def __init__(self, dim: int, ngraphs: int, *, eval_cg_iters: int = 3):
        super().__init__()
        self.skip_weight = nn.Parameter(torch.full((2,), 0.5))
        self.local_filter = MixtureGTVGLR(
            n_graphs=ngraphs, n_node_fts=dim // ngraphs,
            eval_cg_iters=eval_cg_iters)

    def forward(self, x):
        sw = self.skip_weight
        return sw[0] * x + sw[1] * self.local_filter(x)
