"""Restormer-style feature blocks of the pixel-domain family, channels-first
(counterpart: ``irdu_tpu/models/restormer_blocks.py``). Module and parameter
names mirror the flax scopes, so a JAX snapshot loads with
``utils.weights.params_to_torch``. All of it is convolutions (cuDNN on the
card); the JAX package computes it outside Pallas too.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from irdu_tpu_torch.models.layers import Conv3x3Zero, GroupedPointwise, remat_call


class ChannelVarNorm(nn.Module):
    """Divide by the unbiased (ddof = 1) variance over all channels, eps 1e-5
    inside the square root, without subtracting the mean from the output;
    then a per-channel learned scale."""

    def __init__(self, nchannels: int):
        super().__init__()
        self.nchannels = nchannels
        self.weighted_transform = nn.Parameter(torch.ones(nchannels))

    def forward(self, x):
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().sum(dim=1, keepdim=True) / (self.nchannels - 1)
        return x / torch.sqrt(var + 1e-5) * self.weighted_transform[:, None, None]


def _gated_dconv(x, project_in, dwconv, project_out):
    """1×1 expand to 2h → depthwise 3×3 → erf-GELU(first h)·(last h) → 1×1."""
    x1, x2 = dwconv(project_in(x)).chunk(2, dim=1)
    return project_out(F.gelu(x1) * x2)


class GatedDConvFeedForward(nn.Module):
    """Restormer GDFN with hidden width int(dim·ffn_expansion_factor)."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = GroupedPointwise(dim, 2 * hidden)
        self.dwconv = Conv3x3Zero(2 * hidden, 2 * hidden, groups=2 * hidden)
        self.project_out = GroupedPointwise(hidden, dim)

    def forward(self, x):
        return _gated_dconv(x, self.project_in, self.dwconv, self.project_out)


class FFBlock(nn.Module):
    """norm → GDFN, with a learnable 0.5/0.5 skip."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        self.skip_connect_weight_final = nn.Parameter(torch.tensor([0.5, 0.5]))
        self.norm = ChannelVarNorm(dim)
        self.ffn = GatedDConvFeedForward(dim, ffn_expansion_factor)

    def forward(self, x):
        sw = self.skip_connect_weight_final
        return sw[0] * x + sw[1] * self.ffn(self.norm(x))


class OverlapPatchEmbed(nn.Module):
    """3×3 zero-pad embed."""

    def __init__(self, c_in: int, embed_dim: int):
        super().__init__()
        self.proj = Conv3x3Zero(c_in, embed_dim)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    """3×3 conv n → n/2, then PixelUnshuffle(2): channels double, extent halves."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body_conv = Conv3x3Zero(n_feat, n_feat // 2)

    def forward(self, x):
        return F.pixel_unshuffle(self.body_conv(x), 2)


class Upsample(nn.Module):
    """3×3 conv n → 2n, then PixelShuffle(2): channels halve, extent doubles."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body_conv = Conv3x3Zero(n_feat, n_feat * 2)

    def forward(self, x):
        return F.pixel_shuffle(self.body_conv(x), 2)


class FeatureExtraction(nn.Module):
    """The FFBlock U-Net that gives the edge-weight features and the DC
    channels. Level 1 decodes at 2·dim: the upsampled code is concatenated
    with the level-1 skip and not reduced. ``n_levels``: 3, the truncated
    U-Net of the v5+ family, or 4, the v4 full depth (down3_4, the latent
    FFBlocks at 8·dim, up4_3, reduce_chan_level3, decoder_level3). ``remat``:
    each FFBlock recomputed in the backward pass (``layers.remat_call``)."""

    def __init__(self, c_in: int, out_channels: int, dim: int, num_blocks: Sequence[int],
                 num_refinement_blocks: int, ffn_expansion_factor: float, n_levels: int = 3,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if n_levels not in (3, 4):
            raise ValueError(f"n_levels must be 3 or 4, got {n_levels}")
        d, ff = dim, ffn_expansion_factor
        self.n_levels = n_levels
        self.patch_embed = OverlapPatchEmbed(c_in, d)
        self.down1_2 = Downsample(d)
        self.down2_3 = Downsample(2 * d)
        stages = [("encoder_level1", num_blocks[0], d),
                  ("encoder_level2", num_blocks[1], 2 * d),
                  ("encoder_level3", num_blocks[2], 4 * d)]
        if n_levels == 4:
            self.down3_4 = Downsample(4 * d)
            self.up4_3 = Upsample(8 * d)
            self.reduce_chan_level3 = GroupedPointwise(8 * d, 4 * d)
            stages += [("latent", num_blocks[3], 8 * d),
                       ("decoder_level3", num_blocks[2], 4 * d)]
        self.up3_2 = Upsample(4 * d)
        self.reduce_chan_level2 = GroupedPointwise(4 * d, 2 * d)
        self.up2_1 = Upsample(2 * d)
        self.output = Conv3x3Zero(2 * d, out_channels)
        stages += [("decoder_level2", num_blocks[1], 2 * d),
                   ("decoder_level1", num_blocks[0], 2 * d),
                   ("refinement", num_refinement_blocks, 2 * d)]
        self.stages = {}  # stage → the names of its FFBlocks, in order
        for stage, n, width in stages:
            self.stages[stage] = [f"{stage}_{i}" for i in range(n)]
            for name in self.stages[stage]:
                self.add_module(name, FFBlock(width, ff))

    def _stage(self, stage, x):
        for name in self.stages[stage]:
            x = remat_call(getattr(self, name), x, self.remat)
        return x

    def forward(self, x):
        enc1 = self._stage("encoder_level1", self.patch_embed(x))
        enc2 = self._stage("encoder_level2", self.down1_2(enc1))
        x = self._stage("encoder_level3", self.down2_3(enc2))
        if self.n_levels == 4:
            enc3 = x
            x = self._stage("latent", self.down3_4(x))
            x = self.reduce_chan_level3(torch.cat([self.up4_3(x), enc3], dim=1))
            x = self._stage("decoder_level3", x)
        x = self.reduce_chan_level2(torch.cat([self.up3_2(x), enc2], dim=1))
        x = self._stage("decoder_level2", x)
        x = self._stage("decoder_level1", torch.cat([self.up2_1(x), enc1], dim=1))
        return self.output(self._stage("refinement", x))


class GatedDConvBlock(nn.Module):
    """The DC estimator's shape: 1×1 → depthwise 3×3 → GELU gate → 1×1."""

    def __init__(self, c_in: int, dim_out: int, hidden_features: int):
        super().__init__()
        h2 = 2 * hidden_features
        self.project_in = GroupedPointwise(c_in, h2)
        self.dwconv = Conv3x3Zero(h2, h2, groups=h2)
        self.project_out = GroupedPointwise(hidden_features, dim_out)

    def forward(self, x):
        return _gated_dconv(x, self.project_in, self.dwconv, self.project_out)
