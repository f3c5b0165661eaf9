"""Restormer (Zamir et al., CVPR 2022), NHWC (B, H, W, C) at the model
boundary and channels-first inside (counterpart:
``irdu_tpu/baselines/restormer.py``): MDTA transposed channel attention,
the GDFN gated feed-forward, a channel LayerNorm with the biased variance
("BiasFree": the mean is taken out of the variance only, not of the
output; "WithBias": mean-subtracted, scale and bias), pixel (un)shuffle
resamplers, a 4-level U-Net and a global input skip. The reference's
configuration: dim 48, blocks (4, 6, 6, 8), heads (1, 2, 4, 8), ffn 2.66,
BiasFree. H and W must be multiples of 8.

MDTA's attention is a plain matmul and softmax in f32 (JAX's einsum with
f32 accumulation), returned in the stream's dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from irdu_tpu_torch.models.layers import Conv3x3Zero, GroupedPointwise, remat_call

NORM_TYPES = ("BiasFree", "WithBias")


class RestormerLayerNorm(nn.Module):
    def __init__(self, dim: int, norm_type: str = "WithBias"):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"norm_type must be one of {NORM_TYPES}, got {norm_type!r}")
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if norm_type == "WithBias" else None

    def forward(self, x):
        mu = x.mean(dim=1, keepdim=True)
        var = (x - mu).square().mean(dim=1, keepdim=True)
        if self.bias is None:
            return x / torch.sqrt(var + 1e-5) * self.weight[:, None, None]
        return (x - mu) / torch.sqrt(var + 1e-5) * self.weight[:, None, None] \
            + self.bias[:, None, None]


class MDTA(nn.Module):
    """Multi-Dconv-head transposed attention: per head a C/heads × C/heads
    attention, queries and keys L2-normalized over the pixels, scaled by the
    head's learned ``temperature``."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = GroupedPointwise(dim, dim * 3, use_bias=use_bias)
        self.qkv_dwconv = Conv3x3Zero(dim * 3, dim * 3, groups=dim * 3, use_bias=use_bias)
        self.project_out = GroupedPointwise(dim, dim, use_bias=use_bias)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w)
                   for t in self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1))
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = q.float() @ k.float().transpose(-2, -1) * self.temperature.float()
        out = torch.softmax(attn, dim=-1) @ v.float()
        return self.project_out(out.to(x.dtype).reshape(b, c, h, w))


class RestormerFeedForward(nn.Module):
    """GDFN: 1×1 expand to 2·hidden, 3×3 depthwise, erf-GELU(first half) ·
    second half, 1×1 back; hidden = ⌊dim · ffn_expansion_factor⌋."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66, use_bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = GroupedPointwise(dim, hidden * 2, use_bias=use_bias)
        self.dwconv = Conv3x3Zero(hidden * 2, hidden * 2, groups=hidden * 2, use_bias=use_bias)
        self.project_out = GroupedPointwise(hidden, dim, use_bias=use_bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False, norm_type: str = "WithBias"):
        super().__init__()
        self.norm1 = RestormerLayerNorm(dim, norm_type)
        self.attn = MDTA(dim, num_heads, use_bias)
        self.norm2 = RestormerLayerNorm(dim, norm_type)
        self.ffn = RestormerFeedForward(dim, ffn_expansion_factor, use_bias)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Restormer(nn.Module):
    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False, norm_type: str = "WithBias",
                 dual_pixel_task: bool = False, remat: bool = False):
        super().__init__()
        d = dim
        self.remat = remat
        self.dual_pixel_task = dual_pixel_task
        self.stages = {}  # scope → number of blocks

        def blocks(width, n_heads, n, scope):
            for i in range(n):
                setattr(self, f"{scope}_{i}", TransformerBlock(
                    width, n_heads, ffn_expansion_factor, use_bias, norm_type))
            self.stages[scope] = n

        self.patch_embed = Conv3x3Zero(inp_channels, d, use_bias=use_bias)
        blocks(d, heads[0], num_blocks[0], "encoder_level1")
        # the resamplers: a bias-free 3x3 conv (flax scope "<name>_conv"), then
        # pixel unshuffle (down: n → 2n channels) or shuffle (up: n → n / 2)
        self.down1_2_conv = Conv3x3Zero(d, d // 2)
        blocks(d * 2, heads[1], num_blocks[1], "encoder_level2")
        self.down2_3_conv = Conv3x3Zero(d * 2, d)
        blocks(d * 4, heads[2], num_blocks[2], "encoder_level3")
        self.down3_4_conv = Conv3x3Zero(d * 4, d * 2)
        blocks(d * 8, heads[3], num_blocks[3], "latent")
        self.up4_3_conv = Conv3x3Zero(d * 8, d * 16)
        self.reduce_chan_level3 = GroupedPointwise(d * 8, d * 4, use_bias=use_bias)
        blocks(d * 4, heads[2], num_blocks[2], "decoder_level3")
        self.up3_2_conv = Conv3x3Zero(d * 4, d * 8)
        self.reduce_chan_level2 = GroupedPointwise(d * 4, d * 2, use_bias=use_bias)
        blocks(d * 2, heads[1], num_blocks[1], "decoder_level2")
        self.up2_1_conv = Conv3x3Zero(d * 2, d * 4)
        blocks(d * 2, heads[0], num_blocks[0], "decoder_level1")
        blocks(d * 2, heads[0], num_refinement_blocks, "refinement")
        if dual_pixel_task:
            self.skip_conv = GroupedPointwise(d, d * 2, use_bias=use_bias)
        self.output = Conv3x3Zero(d * 2, out_channels, use_bias=use_bias)

    def _run(self, x, scope):
        for i in range(self.stages[scope]):
            x = remat_call(getattr(self, f"{scope}_{i}"), x, self.remat)
        return x

    def forward(self, inp_img):
        h, w = inp_img.shape[1:3]
        if h % 8 or w % 8:
            raise ValueError(f"Restormer needs H and W multiples of 8, got {h}x{w}")
        x = self.patch_embed(inp_img.permute(0, 3, 1, 2))
        enc1_in = x
        enc1 = self._run(x, "encoder_level1")
        enc2 = self._run(F.pixel_unshuffle(self.down1_2_conv(enc1), 2), "encoder_level2")
        enc3 = self._run(F.pixel_unshuffle(self.down2_3_conv(enc2), 2), "encoder_level3")
        x = self._run(F.pixel_unshuffle(self.down3_4_conv(enc3), 2), "latent")
        x = torch.cat([F.pixel_shuffle(self.up4_3_conv(x), 2), enc3], dim=1)
        x = self._run(self.reduce_chan_level3(x), "decoder_level3")
        x = torch.cat([F.pixel_shuffle(self.up3_2_conv(x), 2), enc2], dim=1)
        x = self._run(self.reduce_chan_level2(x), "decoder_level2")
        x = torch.cat([F.pixel_shuffle(self.up2_1_conv(x), 2), enc1], dim=1)
        x = self._run(x, "decoder_level1")
        x = self._run(x, "refinement")
        if self.dual_pixel_task:
            return self.output(x + self.skip_conv(enc1_in)).permute(0, 2, 3, 1)
        return self.output(x).permute(0, 2, 3, 1) + inp_img
