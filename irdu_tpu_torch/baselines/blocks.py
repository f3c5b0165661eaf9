"""Block library of the DRUNet-family baselines, channels-first (B, C, H, W)
(counterpart: ``irdu_tpu/baselines/blocks.py``): the conv + norm + act
builder, the 2× resamplers, IMDB, channel attention (CA, RCAB, RCAG), the
residual dense blocks (RDB, RRDB) and the embedded-Gaussian non-local block.

Module and parameter names mirror the flax scopes, so that
``utils.weights.params_to_torch`` lands a JAX tree on them: a conv's flax
kernel (kh, kw, I, O) (a transposed conv's (kh, kw, O, I)) goes to the
conv2d weight (O, I, kh, kw) (conv_transpose2d's (I, O, kh, kw)) by
``kernel_to_torch``; a BatchNorm's flax ``scale`` is its ``weight`` and its
``batch_stats`` ``mean``/``var`` its running buffers (``FLAX_NAMES``).
Initialization is torch's conv default, U(±1/√fan_in), for kernel and bias.
Everything here is cuDNN/cuBLAS work on the card; the JAX package computes
it on XLA too.
"""

from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from irdu_tpu_torch.models.layers import uniform_param

ACTS = ("relu", "leaky", "sigmoid", "none")


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, H·r, W·r) → (B, C·r², H, W), channel c·r² + i·r + j (torch's
    order, which the JAX package's NHWC version keeps)."""
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of ``pixel_unshuffle``: (B, C·r², H, W) → (B, C, H·r, W·r)."""
    return F.pixel_shuffle(x, r)


def apply_act(y: torch.Tensor, act: str, neg_slope: float = 0.2) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "leaky":
        return F.leaky_relu(y, neg_slope)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act != "none":
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return y


def conv_kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
    """flax (kh, kw, I, O) → conv2d (O, I, kh, kw); equally a transposed
    conv's flax (kh, kw, O, I) → conv_transpose2d (I, O, kh, kw). (JAX flips
    the transposed kernel's taps before ``lax.conv_transpose``, which makes
    it torch's conv_transpose2d with the taps as stored.)"""
    return k.permute(3, 2, 0, 1)


def conv_kernel_from_torch(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-4)`` over channels. In
    eval mode the running statistics are read. In train mode the batch's
    statistics normalize, as flax computes them (f32, the variance
    E[x²] − E[x]² clipped at 0, biased), and the running statistics move
    by 0.1 of the way to them (torch's momentum 0.1 is flax's 0.9; torch's
    own layer would move the variance to the unbiased estimate). Under data
    parallelism (``data``: the data group and its size, set by
    ``train.steps.distribute``) the statistics are the global batch's, as
    JAX's over its sharded batch axis: the ranks' equal-sized means of x
    and x² are averaged by an all-reduce, with its gradient."""

    FLAX_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
    data = None  # (process group, ranks) of the data axis

    def __init__(self, features: int):
        super().__init__(features, eps=1e-4, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        moments = torch.stack([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
        if self.data is not None:
            group, ranks = self.data
            moments = dist_fn.all_reduce(moments, group=group) / ranks
        mean, sq = moments.unbind()
        var = torch.clamp(sq - mean.square(), min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        y = (xf - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class ConvAct(nn.Module):
    """conv (+ BatchNorm) (+ activation), the basicblock ``conv`` builder:
    k×k, stride, dilation, zero padding (default the dilated 'same')."""

    def __init__(self, c_in: int, features: int, ksize: int = 3, use_bias: bool = True,
                 act: str = "relu", neg_slope: float = 0.2, dilation: int = 1,
                 stride: int = 1, padding: int | None = None, use_bn: bool = False):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"act must be one of {ACTS}, got {act!r}")
        fan_in = c_in * ksize * ksize
        self.weight = uniform_param((features, c_in, ksize, ksize), fan_in)
        self.bias = uniform_param((features,), fan_in) if use_bias else None
        self.bn = BatchNorm(features) if use_bn else None
        self.act, self.neg_slope = act, neg_slope
        self.stride, self.dilation = stride, dilation
        self.padding = dilation * (ksize // 2) if padding is None else padding

    kernel_to_torch = staticmethod(conv_kernel_to_torch)
    kernel_from_torch = staticmethod(conv_kernel_from_torch)

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)
        if self.bn is not None:
            y = self.bn(y)
        return apply_act(y, self.act, self.neg_slope)


class ConvTransposeAct(nn.Module):
    """k×k stride-k transposed conv (+ BN) (+ act), the basicblock
    ``upsample_convtranspose`` builder; torch's fan-in, O·k²."""

    def __init__(self, c_in: int, features: int, ksize: int = 2, use_bias: bool = True,
                 act: str = "none", neg_slope: float = 0.2, use_bn: bool = False):
        super().__init__()
        fan_in = features * ksize * ksize
        self.weight = uniform_param((c_in, features, ksize, ksize), fan_in)
        self.bias = uniform_param((features,), fan_in) if use_bias else None
        self.bn = BatchNorm(features) if use_bn else None
        self.act, self.neg_slope, self.ksize = act, neg_slope, ksize

    kernel_to_torch = staticmethod(conv_kernel_to_torch)
    kernel_from_torch = staticmethod(conv_kernel_from_torch)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight, self.bias, stride=self.ksize)
        if self.bn is not None:
            y = self.bn(y)
        return apply_act(y, self.act, self.neg_slope)


DOWN_MODES = ("strideconv", "maxpool", "avgpool")
UP_MODES = ("convtranspose", "upconv", "pixelshuffle")


class Downsample(nn.Module):
    """2× down: 'strideconv' (2×2 stride-2 conv), 'maxpool' / 'avgpool' (a
    2×2 pool, then a 3×3 conv with padding 0 after the max pool and 1 after
    the mean pool: the reference's asymmetry, kept)."""

    def __init__(self, c_in: int, features: int, mode: str = "strideconv",
                 use_bias: bool = True, act: str = "none", use_bn: bool = False):
        super().__init__()
        if mode not in DOWN_MODES:
            raise ValueError(f"mode must be one of {DOWN_MODES}, got {mode!r}")
        self.mode = mode
        kw = dict(use_bias=use_bias, act=act, use_bn=use_bn)
        if mode == "strideconv":
            self.conv = ConvAct(c_in, features, ksize=2, stride=2, padding=0, **kw)
        else:
            self.conv = ConvAct(c_in, features, ksize=3,
                                padding=0 if mode == "maxpool" else 1, **kw)

    def forward(self, x):
        if self.mode == "maxpool":
            x = F.max_pool2d(x, 2)
        elif self.mode == "avgpool":
            x = F.avg_pool2d(x, 2)
        return self.conv(x)


class Upsample(nn.Module):
    """2× up: 'convtranspose' (2×2 stride-2), 'upconv' (nearest 2×, then a
    3×3 conv), 'pixelshuffle' (a 3×3 conv to 4·features, then the shuffle,
    then the activation at slope 0.2)."""

    def __init__(self, c_in: int, features: int, mode: str = "convtranspose",
                 use_bias: bool = True, act: str = "none", use_bn: bool = False):
        super().__init__()
        if mode not in UP_MODES:
            raise ValueError(f"mode must be one of {UP_MODES}, got {mode!r}")
        self.mode, self.act = mode, act
        kw = dict(use_bias=use_bias, act=act, use_bn=use_bn)
        if mode == "convtranspose":
            self.conv = ConvTransposeAct(c_in, features, **kw)
        elif mode == "upconv":
            self.conv = ConvAct(c_in, features, **kw)
        else:
            self.conv = ConvAct(c_in, features * 4, use_bias=use_bias, act="none")

    def forward(self, x):
        if self.mode == "upconv":
            x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        y = self.conv(x)
        if self.mode == "pixelshuffle":
            y = apply_act(pixel_shuffle(y, 2), self.act, 0.2)
        return y


class IMDBlock(nn.Module):
    """Information multi-distillation block: three distill/refine conv
    splits (d_nc = ⌊features·d_rate⌋ distilled channels each), a fourth conv
    to d_nc, a 1×1 fuse of the four, residual add. Leaky slope 0.05."""

    def __init__(self, features: int, d_rate: float = 0.25, use_bias: bool = True,
                 act: str = "leaky", neg_slope: float = 0.05):
        super().__init__()
        d = self.d_nc = int(features * d_rate)
        kw = dict(use_bias=use_bias, act=act, neg_slope=neg_slope)
        self.conv1 = ConvAct(features, features, **kw)
        self.conv2 = ConvAct(features - d, features, **kw)
        self.conv3 = ConvAct(features - d, features, **kw)
        self.conv4 = ConvAct(features - d, d, use_bias=use_bias, act="none")
        self.conv1x1 = ConvAct(4 * d, features, ksize=1, use_bias=use_bias, act="none")

    def forward(self, x):
        d = self.d_nc
        d1, r = self.conv1(x).tensor_split([d], dim=1)
        d2, r = self.conv2(r).tensor_split([d], dim=1)
        d3, r = self.conv3(r).tensor_split([d], dim=1)
        r = self.conv4(r)
        return x + self.conv1x1(torch.cat([d1, d2, d3, r], dim=1))


class CALayer(nn.Module):
    """Channel attention: global mean → 1×1 squeeze (ReLU) → 1×1 excite
    (sigmoid) → gate."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        self.fc1 = ConvAct(features, features // reduction, ksize=1, act="relu")
        self.fc2 = ConvAct(features // reduction, features, ksize=1, act="sigmoid")

    def forward(self, x):
        return x * self.fc2(self.fc1(x.mean(dim=(2, 3), keepdim=True)))


class RCABlock(nn.Module):
    """conv-ReLU-conv → channel attention → + x."""

    def __init__(self, features: int, reduction: int = 16, use_bias: bool = True):
        super().__init__()
        self.conv1 = ConvAct(features, features, use_bias=use_bias, act="relu")
        self.conv2 = ConvAct(features, features, use_bias=use_bias, act="none")
        self.ca = CALayer(features, reduction)

    def forward(self, x):
        return self.ca(self.conv2(self.conv1(x))) + x


class RCAGroup(nn.Module):
    """nb RCABlocks and a trailing conv, residual around the group."""

    def __init__(self, features: int, reduction: int = 16, nb: int = 12,
                 use_bias: bool = True):
        super().__init__()
        self.nb = nb
        for i in range(nb):
            setattr(self, f"rcab{i}", RCABlock(features, reduction, use_bias))
        self.conv = ConvAct(features, features, act="none")

    def forward(self, x):
        y = x
        for i in range(self.nb):
            y = getattr(self, f"rcab{i}")(y)
        return self.conv(y) + x


class ResidualDenseBlock5C(nn.Module):
    """Five densely connected convs (growth gc), 0.2-scaled residual."""

    def __init__(self, features: int, gc: int = 32, use_bias: bool = True):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", ConvAct(features + i * gc, gc, use_bias=use_bias))
        self.conv5 = ConvAct(features + 4 * gc, features, use_bias=use_bias, act="none")

    def forward(self, x):
        feats = [x]
        for i in range(1, 5):
            feats.append(getattr(self, f"conv{i}")(torch.cat(feats, dim=1)))
        return self.conv5(torch.cat(feats, dim=1)) * 0.2 + x


class RRDB(nn.Module):
    """Three residual dense blocks, 0.2-scaled outer residual."""

    def __init__(self, features: int, gc: int = 32, use_bias: bool = True):
        super().__init__()
        self.rdb1 = ResidualDenseBlock5C(features, gc, use_bias)
        self.rdb2 = ResidualDenseBlock5C(features, gc, use_bias)
        self.rdb3 = ResidualDenseBlock5C(features, gc, use_bias)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class NonLocalBlock2D(nn.Module):
    """Embedded-Gaussian non-local attention over all pixels: 1×1 θ, φ, g to
    C/2, softmax(θφᵀ)·g (a plain matmul and softmax, as JAX's einsum), a 1×1
    conv with BatchNorm back to C, + x. ``downsample``: φ and g by a 2×2
    stride-2 conv."""

    def __init__(self, features: int, use_bias: bool = True, downsample: bool = False):
        super().__init__()
        inter = features // 2
        pg = dict(ksize=2, stride=2, padding=0) if downsample else dict(ksize=1)
        self.theta = ConvAct(features, inter, ksize=1, use_bias=use_bias, act="none")
        self.phi = ConvAct(features, inter, use_bias=use_bias, act="none", **pg)
        self.g = ConvAct(features, inter, use_bias=use_bias, act="none", **pg)
        self.w = ConvAct(inter, features, ksize=1, use_bias=use_bias, act="none", use_bn=True)

    def forward(self, x):
        b, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)  # (B, HW, C/2)
        phi = self.phi(x).flatten(2)  # (B, C/2, K)
        g = self.g(x).flatten(2).transpose(1, 2)  # (B, K, C/2)
        attn = torch.softmax(theta @ phi, dim=-1)
        y = (attn @ g).transpose(1, 2).reshape(b, -1, h, w)
        return self.w(y) + x
