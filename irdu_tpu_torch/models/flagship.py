"""The flagship model LGU: a 4-scale autoencoder with per-scale latent graph
filtering (counterpart: ``irdu_tpu/models/flagship.py``
``AbstractMultiScaleGraphFilter``, its non-fast path
``decode(filtering(encode(img)))``).

Images are NHWC (B, H, W, 3) at the model boundary, as in the JAX package;
inside, activations and the per-scale codes are channels-first
(B, C, H, W). H and W must be multiples of 16 (3 down-scales plus the
solver's own 2× scale). Module names mirror the flax scopes, so a JAX
snapshot loads with ``utils.weights.params_to_torch``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from irdu_tpu_torch.models.blocks import (
    LocalLowpassFilteringBlock,
    LocalNonLinearBlock,
    RegionalPixelEmbedding,
)
from irdu_tpu_torch.models.layers import Downsample2x2, GroupedPointwise, Upsample2x2


class AbstractMultiScaleGraphFilter(nn.Module):
    def __init__(self, n_channels_in: int = 3, n_channels_out: int = 3,
                 dims: Sequence[int] = (48, 64, 96, 128),
                 hidden_dims: Sequence[int] = (128, 192, 256, 384),
                 ngraphs: Sequence[int] = (4, 4, 8, 8),
                 num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_blocks_out: int = 4, eval_cg_iters: int = 3):
        super().__init__()
        d, hd = dims, hidden_dims

        def blocks(prefix, s, n):
            mods = [LocalNonLinearBlock(d[s], hd[s]) for _ in range(n)]
            for i, m in enumerate(mods):
                self.add_module(f"{prefix}_{i}", m)
            return mods

        self.patch_3x3_embeding = RegionalPixelEmbedding(n_channels_in, d[0])
        self.encoder_scales = [blocks(f"encoder_scale_{s:02d}", s, num_blocks[s])
                               for s in range(4)]
        self.down_samples = [Downsample2x2(d[s], d[s + 1]) for s in range(3)]
        self.local_filters = [
            LocalLowpassFilteringBlock(d[s], ngraphs[s], eval_cg_iters=eval_cg_iters)
            for s in range(4)]
        self.up_samples = [Upsample2x2(d[s + 1], d[s]) for s in range(3)]
        self.combine_channels = [GroupedPointwise(2 * d[s], d[s]) for s in range(3)]
        self.decoder_scales = [blocks(f"decoder_scale_{s:02d}", s, num_blocks[s])
                               for s in range(3)]
        self.refining_block = blocks("refining_block", 0, num_blocks_out)
        self.linear_output = GroupedPointwise(d[0], n_channels_out)
        for s in range(3):
            self.add_module(f"down_sample_{s:02d}_{s + 1:02d}", self.down_samples[s])
            self.add_module(f"up_sample_{s + 1:02d}_{s:02d}", self.up_samples[s])
            self.add_module(f"combine_channels_{s:02d}", self.combine_channels[s])
        for s in range(4):
            self.add_module(f"localfilter_scale_{s:02d}", self.local_filters[s])

    def encode(self, img: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """NHWC image → the 4 per-scale codes, each (B, C_s, H/2ˢ, W/2ˢ)."""
        x = self.patch_3x3_embeding(img.permute(0, 3, 1, 2))
        codes = []
        for s in range(4):
            for block in self.encoder_scales[s]:
                x = block(x)
            codes.append(x)
            if s < 3:
                x = self.down_samples[s](x)
        return tuple(codes)

    def filtering(self, codes):
        """Per-scale unrolled graph filtering of the codes."""
        return tuple(f(c) for f, c in zip(self.local_filters, codes))

    def decode(self, codes) -> torch.Tensor:
        """Codes → NHWC image: mirror decoder with skip-concat + 1×1 combine,
        refinement stack, linear head."""
        x = codes[3]
        for s in (2, 1, 0):
            x = self.up_samples[s](x)
            x = self.combine_channels[s](torch.cat([x, codes[s]], dim=1))
            for block in self.decoder_scales[s]:
                x = block(x)
        for block in self.refining_block:
            x = block(x)
        return self.linear_output(x).permute(0, 2, 3, 1)

    def enc_dec(self, img: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(img))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.decode(self.filtering(self.encode(img)))


def flagship_config() -> dict:
    """The trained flagship (LGU) configuration: 13,278,816 parameters."""
    return dict(n_channels_in=3, n_channels_out=3, dims=(48, 96, 192, 384),
                hidden_dims=(96, 192, 384, 768), ngraphs=(8, 16, 16, 32),
                num_blocks=(4, 6, 6, 8), num_blocks_out=4)


def flagship_lite_config() -> dict:
    """FLOP-reduced configuration (~4× fewer FLOPs than the flagship)."""
    return dict(n_channels_in=3, n_channels_out=3, dims=(24, 48, 96, 192),
                hidden_dims=(48, 96, 192, 384), ngraphs=(4, 8, 8, 16),
                num_blocks=(2, 3, 3, 4), num_blocks_out=2)


def flagship_micro_config() -> dict:
    """Aggressively FLOP-reduced configuration (~12× fewer FLOPs)."""
    return dict(n_channels_in=3, n_channels_out=3, dims=(16, 32, 64, 128),
                hidden_dims=(32, 64, 128, 256), ngraphs=(4, 4, 8, 8),
                num_blocks=(2, 2, 2, 2), num_blocks_out=2)
