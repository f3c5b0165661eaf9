"""Layers of the flagship and the pixel family, channels-first (B, C, H, W).

Weights are stored in PyTorch's conv layouts; ``kernel_to_torch`` converts the
JAX package's flax kernel of the same layer (counterpart:
``irdu_tpu/models/layers.py``, "plain" variant, one channel group):

  GroupedPointwise  flax (I, O)            → conv2d (O, I, 1, 1)
  Conv3x3Replicate  flax HWIO (3, 3, I/g, O) → conv2d (O, I/g, 3, 3)
  Conv3x3Zero       the same
  Downsample2x2     flax (4I, O), row (a·2+b)·I+i → conv2d (O, I, 2, 2)
  Upsample2x2       flax (I, 4O), col (a·2+b)·O+o → conv_transpose2d (I, O, 2, 2)

Initialization follows torch's Conv2d default, U(±1/√fan_in), as the JAX
package does. The pixel family's PixelShuffle and PixelUnshuffle are
``F.pixel_shuffle`` and ``F.pixel_unshuffle``: in NCHW they order channels
as the JAX package's ``pixel_shuffle``/``pixel_unshuffle`` do (c·r² + a·r + b).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform_param(shape, fan_in):
    """A parameter drawn from U(±1/√fan_in), torch's Conv2d default."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class GroupedPointwise(nn.Module):
    """1×1 conv, no bias."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.weight = uniform_param((features, c_in, 1, 1), c_in)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        return k.t()[:, :, None, None]

    def forward(self, x):
        return F.conv2d(x, self.weight)


class Conv3x3Replicate(nn.Module):
    """3×3 stride-1 conv with replicate padding, no bias."""

    def __init__(self, c_in: int, features: int, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = uniform_param((features, c_in // groups, 3, 3), c_in // groups * 9)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        return k.permute(3, 2, 0, 1)

    def forward(self, x):
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), self.weight,
                        groups=self.groups)


class Downsample2x2(nn.Module):
    """Learned 2×2 stride-2 conv, no bias."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.weight = uniform_param((features, c_in, 2, 2), c_in * 4)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        four_i, o = k.shape
        return k.reshape(2, 2, four_i // 4, o).permute(3, 2, 0, 1)

    def forward(self, x):
        return F.conv2d(x, self.weight, stride=2)


class Upsample2x2(nn.Module):
    """Learned 2×2 stride-2 transpose conv, no bias."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        # torch's conv_transpose init takes fan_in from the output side
        self.weight = uniform_param((c_in, features, 2, 2), features * 4)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        i, four_o = k.shape
        return k.reshape(i, 2, 2, four_o // 4).permute(0, 3, 1, 2)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, stride=2)


def box_down2x2(x: torch.Tensor) -> torch.Tensor:
    """Fixed 2×2 box mean over the last two axes (the solver's down-scale)."""
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
                   + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])


def box_up2x2(t: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``box_down2x2``: duplicate each pixel 2×2 AND scale by 0.25."""
    return 0.25 * t.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Conv3x3Zero(nn.Module):
    """3×3 stride-1 conv with zero padding (torch Conv2d padding=1), no bias;
    the pixel family's feature U-Net and DC estimator use it. Same flax
    kernel layout as ``Conv3x3Replicate``."""

    def __init__(self, c_in: int, features: int, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = uniform_param((features, c_in // groups, 3, 3), c_in // groups * 9)

    kernel_to_torch = staticmethod(Conv3x3Replicate.kernel_to_torch)

    def forward(self, x):
        return F.conv2d(x, self.weight, padding=1, groups=self.groups)
