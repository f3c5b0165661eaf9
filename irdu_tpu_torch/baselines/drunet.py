"""The DRUNet-family baselines (Zhang et al.), NHWC (B, H, W, C) at the model
boundary and channels-first inside (counterpart:
``irdu_tpu/baselines/drunet.py``):

  DnCNN        residual conv stack, x − f(x); act_mode "R" or "BR" (BN);
  FDnCNN       the same without the residual (noise-map channel in in_nc);
  IRCNN        7 dilated convs (1, 2, 3, 4, 3, 2, 1), residual;
  UNet         4-scale conv U-Net, additive skips, global residual;
  UNetRes      "DRUNet": bias-free ResBlocks, 2×2 strided-conv down,
               transposed-conv up, additive skips (no input residual);
  ResUNet      IMDB U-Net, its own replicate pad to a multiple of 8, crop;
  UNetResSubP  a biased UNetRes inside pixel (un)shuffle, global residual;
  UNetPlus     BN-heavy conv U-Net (a stage's last conv before a resample
               without BN);
  NonLocalUNet UNet with non-local attention around the third scale.

Module names mirror the flax scopes; UNetRes keeps its resampling kernels
as flax stores them (``ds1_kernel`` (2, 2, I, O), ``us1_kernel`` (2, 2, O,
I)), since flax names them as parameters of the model itself.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from irdu_tpu_torch.baselines.blocks import (
    ConvAct,
    Downsample,
    IMDBlock,
    NonLocalBlock2D,
    Upsample,
    conv_kernel_to_torch,
    pixel_shuffle,
    pixel_unshuffle,
)
from irdu_tpu_torch.models.layers import Conv3x3Zero, uniform_param


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _act_of(act_mode: str) -> str:
    return "leaky" if act_mode[-1] == "L" else "relu"


def _chain(module: nn.Module, x, scope: str, n: int, part: str = "c"):
    """``x`` through ``module.<scope>_<part><i>`` for i < n."""
    for i in range(n):
        x = getattr(module, f"{scope}_{part}{i}")(x)
    return x


class DnCNN(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64, nb: int = 17,
                 act_mode: str = "BR"):
        super().__init__()
        use_bn = "B" in act_mode
        self.nb = nb
        self.head = ConvAct(in_nc, nc, act="relu")
        for i in range(nb - 2):
            setattr(self, f"body_{i}", ConvAct(nc, nc, act="relu", use_bn=use_bn))
        self.tail = ConvAct(nc, out_nc, act="none")

    def forward(self, x):
        y = self.head(_nchw(x))
        for i in range(self.nb - 2):
            y = getattr(self, f"body_{i}")(y)
        return x - _nhwc(self.tail(y))


class FDnCNN(nn.Module):
    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: int = 64, nb: int = 20):
        super().__init__()
        self.nb = nb
        self.head = ConvAct(in_nc, nc, act="relu")
        for i in range(nb - 2):
            setattr(self, f"body_{i}", ConvAct(nc, nc, act="relu"))
        self.tail = ConvAct(nc, out_nc, act="none")

    def forward(self, x):
        y = self.head(_nchw(x))
        for i in range(self.nb - 2):
            y = getattr(self, f"body_{i}")(y)
        return _nhwc(self.tail(y))


class IRCNN(nn.Module):
    DILATIONS = (1, 2, 3, 4, 3, 2, 1)

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64):
        super().__init__()
        n = len(self.DILATIONS)
        for i, d in enumerate(self.DILATIONS):
            last = i == n - 1
            setattr(self, f"layer_{i}", ConvAct(in_nc if i == 0 else nc, out_nc if last else nc,
                                                act="none" if last else "relu", dilation=d))

    def forward(self, x):
        return x - _nhwc(_chain(self, _nchw(x), "layer", len(self.DILATIONS), part=""))


class ResBlockCRC(nn.Module):
    """conv-ReLU-conv, + x; bias-free unless ``use_bias``."""

    def __init__(self, nc: int, use_bias: bool = False):
        super().__init__()
        self.conv1 = Conv3x3Zero(nc, nc, use_bias=use_bias)
        self.conv2 = Conv3x3Zero(nc, nc, use_bias=use_bias)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class UNetRes(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 4):
        super().__init__()
        self.nb = nb
        self.head = Conv3x3Zero(in_nc, nc[0])
        scopes = (("down1", nc[0]), ("down2", nc[1]), ("down3", nc[2]), ("body", nc[3]),
                  ("up3", nc[2]), ("up2", nc[1]), ("up1", nc[0]))
        for scope, c in scopes:
            for i in range(nb):
                setattr(self, f"{scope}_res{i}", ResBlockCRC(c))
        for k in (1, 2, 3):  # flax layouts: down (2, 2, I, O), up (2, 2, O, I)
            setattr(self, f"ds{k}_kernel", uniform_param((2, 2, nc[k - 1], nc[k]), nc[k - 1] * 4))
            setattr(self, f"us{k}_kernel", uniform_param((2, 2, nc[k - 1], nc[k]), nc[k - 1] * 4))
        self.tail = Conv3x3Zero(nc[0], out_nc)

    def _down(self, x, k):
        return F.conv2d(x, conv_kernel_to_torch(getattr(self, f"ds{k}_kernel")), stride=2)

    def _up(self, x, k):
        return F.conv_transpose2d(x, conv_kernel_to_torch(getattr(self, f"us{k}_kernel")),
                                  stride=2)

    def _res(self, x, scope):
        return _chain(self, x, scope, self.nb, part="res")

    def forward(self, x0):
        x1 = self.head(_nchw(x0))
        x2 = self._down(self._res(x1, "down1"), 1)
        x3 = self._down(self._res(x2, "down2"), 2)
        x4 = self._down(self._res(x3, "down3"), 3)
        x = self._res(x4, "body")
        x = self._res(self._up(x + x4, 3), "up3")
        x = self._res(self._up(x + x3, 2), "up2")
        x = self._res(self._up(x + x2, 1), "up1")
        return _nhwc(self.tail(x + x1))


class _ConvUNet(nn.Module):
    """The skeleton UNet, UNetPlus and NonLocalUNet share: head, three
    (convs, down) stages, the body, three (up, convs) stages, the tail;
    additive skips before each up stage and before the tail; + the input."""

    def _stage_convs(self, scope, c_in, c, n, act, bn, last_plain=False):
        for i in range(n):
            plain = last_plain and i == n - 1
            setattr(self, f"{scope}_c{i}", ConvAct(c_in if i == 0 else c, c, act=act,
                                                   use_bn=bn and not plain))

    def forward(self, x0):
        nb = self.nb
        x1 = self.head(_nchw(x0))
        x2 = self.ds1(_chain(self, x1, "down1", nb))
        x3 = self.ds2(_chain(self, x2, "down2", nb))
        x4 = self.ds3(_chain(self, self.before_down3(x3), "down3", nb))
        x = _chain(self, x4, "body", nb + 1)
        x = self.after_up3(_chain(self, self.us3(x + x4), "up3", nb))
        x = _chain(self, self.us2(x + x3), "up2", nb)
        x = _chain(self, self.us1(x + x2), "up1", nb)
        return x0 + _nhwc(self.tail(x + x1))

    def before_down3(self, x):
        return x

    def after_up3(self, x):
        return x


class UNet(_ConvUNet):
    def __init__(self, in_nc: int = 1, out_nc: int = 1,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 2, act_mode: str = "R",
                 downsample_mode: str = "strideconv", upsample_mode: str = "convtranspose"):
        super().__init__()
        act, bn = _act_of(act_mode), "B" in act_mode
        self.nb = nb
        self.head = ConvAct(in_nc, nc[0], act=act)
        for k, scope in ((1, "down1"), (2, "down2"), (3, "down3")):
            self._stage_convs(scope, nc[k - 1], nc[k - 1], nb, act, bn)
            setattr(self, f"ds{k}", Downsample(nc[k - 1], nc[k], downsample_mode, act=act,
                                               use_bn=bn))
            setattr(self, f"us{k}", Upsample(nc[k], nc[k - 1], upsample_mode, act=act,
                                             use_bn=bn))
            self._stage_convs(f"up{k}", nc[k - 1], nc[k - 1], nb, act, bn)
        self._stage_convs("body", nc[3], nc[3], nb + 1, act, bn)
        self.tail = ConvAct(nc[0], out_nc, act="none")


class UNetPlus(_ConvUNet):
    def __init__(self, in_nc: int = 3, out_nc: int = 3,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 1, act_mode: str = "BR"):
        super().__init__()
        if len(act_mode) != 2:
            raise ValueError(f"UNetPlus needs a 2-char act_mode (e.g. 'BR'), got {act_mode!r}")
        act, bn = _act_of(act_mode), "B" in act_mode
        self.nb = nb
        self.head = ConvAct(in_nc, nc[0], act="none")
        for k, scope in ((1, "down1"), (2, "down2"), (3, "down3")):
            self._stage_convs(scope, nc[k - 1], nc[k - 1], nb, act, bn)
            setattr(self, f"ds{k}", Downsample(nc[k - 1], nc[k], act=act))
            setattr(self, f"us{k}", Upsample(nc[k], nc[k - 1], act=act, use_bn=bn))
            self._stage_convs(f"up{k}", nc[k - 1], nc[k - 1], nb, act, bn, last_plain=True)
        self._stage_convs("body", nc[3], nc[3], nb + 1, act, bn)
        self.tail = ConvAct(nc[0], out_nc, act="none")


class NonLocalUNet(_ConvUNet):
    def __init__(self, in_nc: int = 3, out_nc: int = 3,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 1, act_mode: str = "R"):
        super().__init__()
        act = _act_of(act_mode)
        self.nb = nb
        self.head = ConvAct(in_nc, nc[0], act=act)
        for k, scope in ((1, "down1"), (2, "down2"), (3, "down3")):
            self._stage_convs(scope, nc[k - 1], nc[k - 1], nb, act, False)
            setattr(self, f"ds{k}", Downsample(nc[k - 1], nc[k], act=act))
            setattr(self, f"us{k}", Upsample(nc[k], nc[k - 1], act=act))
            self._stage_convs(f"up{k}", nc[k - 1], nc[k - 1], nb, act, False)
        self._stage_convs("body", nc[3], nc[3], nb + 1, act, False)
        self.nl_down = NonLocalBlock2D(nc[2])
        self.nl_up = NonLocalBlock2D(nc[2])
        self.tail = ConvAct(nc[0], out_nc, act="none")

    def before_down3(self, x):
        return self.nl_down(x)

    def after_up3(self, x):
        return self.nl_up(x)


class ResUNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 4, act_mode: str = "L"):
        super().__init__()
        act = _act_of(act_mode)
        self.nb = nb
        self.head = ConvAct(in_nc, nc[0], use_bias=False, act="none")
        scopes = (("down1", nc[0]), ("down2", nc[1]), ("down3", nc[2]), ("body", nc[3]),
                  ("up3", nc[2]), ("up2", nc[1]), ("up1", nc[0]))
        for scope, c in scopes:
            for i in range(nb):
                setattr(self, f"{scope}_imdb{i}", IMDBlock(c, use_bias=False, act=act))
        for k in (1, 2, 3):
            setattr(self, f"ds{k}", Downsample(nc[k - 1], nc[k], use_bias=False))
            setattr(self, f"us{k}", Upsample(nc[k], nc[k - 1], use_bias=False))
        self.tail = ConvAct(nc[0], out_nc, use_bias=False, act="none")

    def _imdbs(self, y, scope):
        return _chain(self, y, scope, self.nb, part="imdb")

    def forward(self, x):
        h, w = x.shape[1:3]
        # replicate pad to a multiple of 8 (bottom, right), cropped at the end
        y0 = F.pad(_nchw(x), (0, (-w) % 8, 0, (-h) % 8), mode="replicate")
        x1 = self.head(y0)
        x2 = self.ds1(self._imdbs(x1, "down1"))
        x3 = self.ds2(self._imdbs(x2, "down2"))
        x4 = self.ds3(self._imdbs(x3, "down3"))
        y = self._imdbs(x4, "body")
        y = self._imdbs(self.us3(y + x4), "up3")
        y = self._imdbs(self.us2(y + x3), "up2")
        y = self._imdbs(self.us1(y + x2), "up1")
        return _nhwc(self.tail(y + x1))[:, :h, :w]


class UNetResSubP(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 2, act_mode: str = "R"):
        super().__init__()
        act = _act_of(act_mode)
        self.nb = nb
        self.head = ConvAct(in_nc * 4, nc[0], act=act)
        scopes = (("down1", nc[0]), ("down2", nc[1]), ("down3", nc[2]), ("body", nc[3]),
                  ("up3", nc[2]), ("up2", nc[1]), ("up1", nc[0]))
        for scope, c in scopes:
            for i in range(nb):
                setattr(self, f"{scope}_res{i}", ResBlockCRC(c, use_bias=True))
        self.body_res_extra = ResBlockCRC(nc[3], use_bias=True)
        for k in (1, 2, 3):
            setattr(self, f"ds{k}", Downsample(nc[k - 1], nc[k], act=act))
            setattr(self, f"us{k}", Upsample(nc[k], nc[k - 1], act=act))
        self.tail = ConvAct(nc[0], out_nc * 4, use_bias=False, act="none")

    def _res(self, x, scope):
        return _chain(self, x, scope, self.nb, part="res")

    def forward(self, x0):
        x1 = self.head(pixel_unshuffle(_nchw(x0), 2))
        x2 = self.ds1(self._res(x1, "down1"))
        x3 = self.ds2(self._res(x2, "down2"))
        x4 = self.ds3(self._res(x3, "down3"))
        x = self.body_res_extra(self._res(x4, "body"))
        x = self._res(self.us3(x + x4), "up3")
        x = self._res(self.us2(x + x3), "up2")
        x = self._res(self.us1(x + x2), "up1")
        return _nhwc(pixel_shuffle(self.tail(x + x1), 2)) + x0
