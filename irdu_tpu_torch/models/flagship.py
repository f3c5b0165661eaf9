"""The flagship model LGU: a 4-scale autoencoder with per-scale latent graph
filtering (counterpart: ``irdu_tpu/models/flagship.py``
``AbstractMultiScaleGraphFilter``, its CHW fast path ``_forward_fast`` with
``use_pallas_blocks=True``).

Images are NHWC (B, H, W, 3) at the model boundary, as in the JAX package;
inside, activations and the per-scale codes are channels-first
(B, C, H, W). H and W must be multiples of 16 (3 down-scales plus the
solver's own 2× scale). Module names mirror the flax scopes, so a JAX
snapshot loads with ``utils.weights.params_to_torch``.

The port is channels-first throughout, so ``irdu_tpu/models/chw.py`` has no
copy here: ``Downsample2x2``, ``Upsample2x2`` and ``GroupedPointwise``
(``models/layers.py``) already compute its ``downsample2x2_chw``,
``upsample2x2_chw`` and ``pointwise_chw``.

Block routing (``run_blocks``), with the attribute ``use_kernels`` True: a
block list of width ≤ 64 runs through K3 (``fused_block_stack``) in chunks of
at most 4 blocks, every other list block by block through K4
(``fused_gated_block``). A CPU tensor takes the kernels' plain versions; a
CUDA tensor the kernels cannot take raises. The JAX package also requires
W % 128 == 0 for K3 (a TPU lane rule) and sends other widths to K4; the port
does not, so at 480×320 its scale 0 runs K3 where JAX runs K4. The routing
differs there, the arithmetic does not. With ``use_kernels`` False every
block runs as its module's PyTorch ops (cuDNN on the card): the on-card
reference the kernel path is held to. A ``conv_variant`` other than "plain"
(spectral norm, non-expansive) takes the same routes: its factors are
folded into the blocks' kernel operands (``blocks.gated_params``), where
JAX runs such blocks on XLA outside its Pallas kernels. So does a model of
``nsubnets`` > 1: its blocks' grouped expand and project go to K3/K4 as
dense block-diagonal operands, and the kernels normalize over each
subnet's channels (JAX runs the whole forward of such a model on XLA); its
grouped down/up samples and combines are PyTorch's grouped convs.
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
from irdu_tpu_torch.models.layers import Downsample2x2, GroupedPointwise, Upsample2x2, remat_call
from irdu_tpu_torch.models.registry import require
from irdu_tpu_torch.ops.block_stack import fused_block_stack, pack_block_params
from irdu_tpu_torch.ops.gated_block import fused_gated_block
from irdu_tpu_torch.ops.windows import WINDOWS

STACK_MAX_DIM = 64  # block lists this wide run through K3
STACK_MAX_BLOCKS = 4


class AbstractMultiScaleGraphFilter(nn.Module):
    def __init__(self, n_channels_in: int = 3, n_channels_out: int = 3,
                 dims: Sequence[int] = (48, 64, 96, 128),
                 hidden_dims: Sequence[int] = (128, 192, 256, 384),
                 ngraphs: Sequence[int] = (4, 4, 8, 8),
                 num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_blocks_out: int = 4, eval_cg_iters: int = 3,
                 eval_filter_scales: Sequence[int] | None = None, *,
                 nsubnets: Sequence[int] = (1, 1, 1, 1), window: str = "cross4",
                 conv_variant: str = "plain", use_pallas_blocks: bool = False,
                 use_pallas_solver: bool = False, remat: bool = False):
        """eval_filter_scales: filter only these scales' codes, identity
        elsewhere (not in the reference; None filters all four).

        The other keywords are JAX's fields with JAX's defaults, so that a
        configuration's ``model`` section builds: ``nsubnets`` all 1 is
        one subnet, other values split each scale's blocks, down-sample,
        up-sample (by the coarser scale's count) and combine into that many
        channel groups, as JAX does; ``window`` ("cross4", "diamond12" or
        "ring8") is the solvers' graph window (every plane of a window other
        than cross-4 takes the K5 band route: K1 is built for cross-4).
        ``conv_variant`` ("plain", "spectral_norm", "non_expansive") goes to
        the embed, the blocks, the down/up samples, the combines and the
        head, not the solvers. The
        ``use_pallas_*`` flags choose between two computations of the same
        function in JAX; the port routes by device (kernels on a CUDA
        tensor, their plain versions on a CPU one) and ``use_kernels``, so
        both values build the same model. ``remat`` (the attribute of the
        same name; ``registry.set_remat`` flips it) recomputes each block of
        the plain route and each filtering block in the backward pass
        (``layers.remat_call``), JAX's ``nn.remat``: a training-memory knob
        with the same values and no effect at inference."""
        require("window", window, list(WINDOWS), "JAX's WINDOWS has no such window")
        del use_pallas_blocks, use_pallas_solver
        super().__init__()
        d, hd, ns = dims, hidden_dims, tuple(nsubnets)
        for s in range(4):
            widths = (d[s], hd[s]) + ((d[s + 1],) if s < 3 else ()) + (
                (d[s - 1],) if s > 0 else ())
            if any(v % ns[s] for v in widths) or d[s] // ns[s] < 2:
                raise ValueError(f"nsubnets={ns}: {ns[s]} subnets must split scale {s}'s "
                                 f"widths {widths} into runs of 2 or more channels")
        self.dims, self.hidden_dims, self.ngraphs = tuple(dims), tuple(hidden_dims), tuple(ngraphs)
        self.nsubnets = ns
        self.eval_filter_scales = (None if eval_filter_scales is None
                                   else tuple(eval_filter_scales))
        self.use_kernels = True
        self.remat = remat
        cv = conv_variant

        def blocks(prefix, s, n):
            mods = [LocalNonLinearBlock(d[s], hd[s], cv, ns[s]) for _ in range(n)]
            for i, m in enumerate(mods):
                self.add_module(f"{prefix}_{i}", m)
            return mods

        self.patch_3x3_embeding = RegionalPixelEmbedding(n_channels_in, d[0], cv)
        self.encoder_scales = [blocks(f"encoder_scale_{s:02d}", s, num_blocks[s])
                               for s in range(4)]
        self.down_samples = [Downsample2x2(d[s], d[s + 1], cv, groups=ns[s]) for s in range(3)]
        self.local_filters = [
            LocalLowpassFilteringBlock(d[s], ngraphs[s], eval_cg_iters=eval_cg_iters,
                                       window=window, nsubnets=ns[s])
            for s in range(4)]
        self.up_samples = [Upsample2x2(d[s + 1], d[s], cv, groups=ns[s + 1]) for s in range(3)]
        self.combine_channels = [GroupedPointwise(2 * d[s], d[s], cv, groups=ns[s])
                                 for s in range(3)]
        self.decoder_scales = [blocks(f"decoder_scale_{s:02d}", s, num_blocks[s])
                               for s in range(3)]
        self.refining_block = blocks("refining_block", 0, num_blocks_out)
        self.linear_output = GroupedPointwise(d[0], n_channels_out, cv)
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
            x = run_blocks(x, self.encoder_scales[s], self.use_kernels, self.remat)
            codes.append(x)
            if s < 3:
                x = self.down_samples[s](x)
        return tuple(codes)

    def filtering(self, codes):
        """Per-scale unrolled graph filtering of the codes
        (``eval_filter_scales`` passes the others through)."""
        keep = range(4) if self.eval_filter_scales is None else self.eval_filter_scales
        return tuple(remat_call(f, c, self.remat) if s in keep else c
                     for s, (f, c) in enumerate(zip(self.local_filters, codes)))

    def decode(self, codes) -> torch.Tensor:
        """Codes → NHWC image: mirror decoder with skip-concat + 1×1 combine,
        refinement stack, linear head."""
        x = codes[3]
        for s in (2, 1, 0):
            x = self.up_samples[s](x)
            x = self.combine_channels[s](torch.cat([x, codes[s]], dim=1))
            x = run_blocks(x, self.decoder_scales[s], self.use_kernels, self.remat)
        x = run_blocks(x, self.refining_block, self.use_kernels, self.remat)
        return self.linear_output(x).permute(0, 2, 3, 1)

    def enc_dec(self, img: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(img))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.decode(self.filtering(self.encode(img)))


def run_blocks(x, blocks, use_kernels=True, remat=False):
    """A list of LocalNonLinearBlocks over x (B, C, H, W): with
    ``use_kernels``, through K3 in chunks of ``STACK_MAX_BLOCKS`` when
    C ≤ ``STACK_MAX_DIM``, else block by block through K4; without, as the
    modules' PyTorch ops, each recomputed in the backward pass with
    ``remat``. The ablations' feature heads run here too."""
    if not use_kernels:
        for block in blocks:
            x = remat_call(block, x, remat)
        return x
    if x.shape[1] <= STACK_MAX_DIM:
        for k in range(0, len(blocks), STACK_MAX_BLOCKS):
            chunk = blocks[k:k + STACK_MAX_BLOCKS]
            x = fused_block_stack(x, *pack_block_params(
                [b.gated_params() for b in chunk], x.dtype), nsubnets=chunk[0].nsubnets)
        return x
    for block in blocks:
        x = fused_gated_block(x, **block.gated_params(), nsubnets=block.nsubnets)
    return x


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
