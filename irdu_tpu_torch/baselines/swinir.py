"""SwinIR (Liang et al., ICCVW 2021), the denoising configuration
(upsampler none, image range 1.0), NHWC (B, H, W, C) at the model boundary
(counterpart: ``irdu_tpu/baselines/swinir.py``): ws×ws window attention
with a relative position bias, shifted windows (the mask −100, not −inf),
residual Swin groups (RSTB) each closed by a 3×3 conv, the RGB mean
(0.4488, 0.4371, 0.4040) taken off and added back, a global input skip.
The reference's configuration: 6 groups of depth 6, embed 180, 6 heads,
window 8, mlp_ratio 2. H and W must be multiples of the window.

The tokens run as (B, H·W, C); the convolutions as (B, C, H, W). The
attention is a plain matmul and softmax in f32 (JAX's einsum with f32
accumulation), returned in the stream's dtype. ``Dense`` and ``LayerNorm``
take flax's names (kernel (I, O), scale).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from irdu_tpu_torch.models.layers import Conv3x3Zero, remat_call

RGB_MEAN = (0.4488, 0.4371, 0.4040)


class Dense(nn.Linear):
    """flax ``nn.Dense``: kernel (I, O) ↔ ``weight`` (O, I); flax's
    initialization (lecun-normal kernel, zero bias) is not reproduced."""

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        return k.t()

    @staticmethod
    def kernel_from_torch(w: torch.Tensor) -> torch.Tensor:
        return w.t()


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` over the last axis; flax's
    ``scale`` is ``weight``."""

    FLAX_NAMES = {"scale": "weight"}

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²): the bias table's row of each (query, key) pair."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def make_shift_mask(h: int, w: int, ws: int, ss: int, device=None) -> torch.Tensor:
    """(nW, ws², ws²): −100 between two pixels of a shifted window that come
    from different regions of the unshifted image, 0 within one (SwinIR's
    ``calculate_mask``)."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        ws, self.num_heads = window_size, num_heads
        self.scale = (dim // num_heads) ** -0.5
        table = torch.empty(((2 * ws - 1) ** 2, num_heads))
        nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04)
        self.relative_position_bias_table = nn.Parameter(table)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(ws).reshape(-1)),
                             persistent=False)
        self.qkv = Dense(dim, dim * 3)
        self.proj = Dense(dim, dim)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q.float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, nh, n, n)
        out = torch.softmax(attn, dim=-1) @ v.float()
        return self.proj(out.to(x.dtype).transpose(1, 2).reshape(b_, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.ws, self.ss = window_size, shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden)
        self.mlp_fc2 = Dense(hidden, dim)

    def forward(self, x, h, w, attn_mask):
        ws, ss = self.ws, self.ss
        b, n, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        if ss > 0:
            y = torch.roll(y, (-ss, -ss), dims=(1, 2))
        yw = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c),
                       attn_mask if ss > 0 else None)
        y = window_reverse(yw.reshape(-1, ws, ws, c), ws, h, w)
        if ss > 0:
            y = torch.roll(y, (ss, ss), dims=(1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class RSTB(nn.Module):
    """``depth`` Swin blocks (every second one shifted by ws/2), a 3×3
    conv, + the group's input."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 8,
                 mlp_ratio: float = 2.0, remat: bool = False):
        super().__init__()
        self.depth, self.remat = depth, remat
        for i in range(depth):
            setattr(self, f"block_{i}", SwinBlock(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio))
        self.conv = Conv3x3Zero(dim, dim, use_bias=True)

    def forward(self, x, h, w, attn_mask):
        b, n, c = x.shape
        res = x
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            x = remat_call(lambda t, blk=block: blk(t, h, w, attn_mask), x, self.remat)
        y = self.conv(x.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(b, n, c) + res


class SwinIR(nn.Module):
    def __init__(self, in_chans: int = 3, out_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, remat: bool = False):
        super().__init__()
        self.in_chans, self.out_chans = in_chans, out_chans
        self.ws, self.embed_dim, self.n_layers = window_size, embed_dim, len(depths)
        self.register_buffer("mean", torch.tensor(RGB_MEAN if in_chans == 3 else (0.0,)),
                             persistent=False)
        self.conv_first = Conv3x3Zero(in_chans, embed_dim, use_bias=True)
        self.patch_norm = LayerNorm(embed_dim)
        for li, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"layers_{li}", RSTB(embed_dim, depth, heads, window_size,
                                               mlp_ratio, remat=remat))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = Conv3x3Zero(embed_dim, embed_dim, use_bias=True)
        self.conv_last = Conv3x3Zero(embed_dim, out_chans, use_bias=True)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws = self.ws
        if h % ws or w % ws:
            raise ValueError(f"SwinIR needs H and W multiples of its window {ws}, got {h}x{w}"
                             " (pad the input)")
        x = x - self.mean
        feat = self.conv_first(x.permute(0, 3, 1, 2))
        tokens = self.patch_norm(feat.flatten(2).transpose(1, 2))
        mask = make_shift_mask(h, w, ws, ws // 2, x.device)
        for li in range(self.n_layers):
            tokens = getattr(self, f"layers_{li}")(tokens, h, w, mask)
        body = self.norm(tokens).transpose(1, 2).reshape(b, self.embed_dim, h, w)
        out = self.conv_last(feat + self.conv_after_body(body)).permute(0, 2, 3, 1)
        return out + x + self.mean if self.in_chans == self.out_chans else out + self.mean
