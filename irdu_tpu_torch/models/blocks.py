"""Encoder/decoder blocks of the flagship LGU model, channels-first
(counterpart: ``irdu_tpu/models/blocks.py``). ``conv_variant`` is JAX's:
"plain", "spectral_norm" or "non_expansive" (``models/layers.py``).
``nsubnets`` (JAX's field) splits a block's channels into that many
subnets: the norm's variance is each subnet's, and the expand and the
project are grouped 1×1 convs (a subnet's C/g inputs to its 2H/g outputs,
and its H/g gate channels to its C/g outputs). The gate still pairs hidden
channel j with j + H, as JAX's split of the expand's output does."""

from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn
from torch import nn

from irdu_tpu_torch.models.layers import (
    VARIANTS,
    Conv3x3Replicate,
    GroupedPointwise,
    cached,
    non_expansive_scale,
    uniform_param,
)
from irdu_tpu_torch.ops.gated_block import subnet_norm
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR


class CustomLayerNorm(nn.Module):
    """Per-pixel variance normalization over each subnet's channels with a
    learned per-channel scale: ``x / sqrt(var + 1e-5) * scale``, the variance
    unbiased (ddof=1) over a subnet's C / ``nsubnets`` channels. The mean is
    NOT subtracted from the output. ``conv_variant``:
    "spectral_norm" divides the scale by its L2 norm; "non_expansive"
    multiplies the output by tanh(1/(|scale|·s + 1e-16)), s the learned
    ``scaling_factor``."""

    def __init__(self, nchannels: int, conv_variant: str = "plain", nsubnets: int = 1):
        super().__init__()
        if conv_variant not in VARIANTS:
            raise ValueError(f"conv_variant must be one of {VARIANTS}, got {conv_variant!r}")
        self.conv_variant = conv_variant
        self.nsubnets = nsubnets
        self.weighted_transform = uniform_param((nchannels,), 1)
        if conv_variant == "non_expansive":
            self.scaling_factor = nn.Parameter(torch.ones(nchannels))

    def effective_scale(self) -> torch.Tensor:
        """The scale with the variant's factor in it, in its dtype (the
        block kernels' ``scale`` operand)."""
        t = self.weighted_transform
        if self.conv_variant == "spectral_norm":
            return cached(self, (t,), lambda: t / torch.clamp(
                torch.linalg.vector_norm(t.float()), min=1e-12).to(t.dtype))
        if self.conv_variant == "non_expansive":
            s = self.scaling_factor
            return cached(self, (t, s), lambda: (t.float() * non_expansive_scale(
                t.abs().float(), s.float())).to(t.dtype))
        return t

    def forward(self, x):
        return subnet_norm(x, self.nsubnets) * self.effective_scale()[None, :, None, None]


class LocalGatedLinearBlock(nn.Module):
    """1×1 expand → 3×3 depthwise (replicate pad) → gate σ(m)·m·u → 1×1 project.

    Under tensor parallelism (``tp``, set by
    ``parallel.tensor.shard_train_state``) the block holds its rank's mask
    and u channels of the expand and the depthwise conv and the matching
    input rows of the project, and all-reduces its output over the model
    group: the Megatron split (one subnet only; a grouped block's weights
    are gathered where it runs, ``parallel/tensor.py``)."""

    tp = None  # parallel.tensor.ModelShard

    def __init__(self, dim: int, hidden_dim: int, conv_variant: str = "plain",
                 nsubnets: int = 1):
        super().__init__()
        h2 = 2 * hidden_dim
        self.nsubnets = nsubnets
        self.channels_linear_op = GroupedPointwise(dim, h2, variant=conv_variant,
                                                   groups=nsubnets)
        self.channels_local_linear_op = Conv3x3Replicate(h2, h2, groups=h2,
                                                         variant=conv_variant)
        self.project_out = GroupedPointwise(hidden_dim, dim, variant=conv_variant,
                                            groups=nsubnets)

    def forward(self, x):
        x = self.channels_local_linear_op(self.channels_linear_op(x))
        mask, u = x.chunk(2, dim=1)
        y = self.project_out(torch.sigmoid(mask) * mask * u)
        if self.tp is not None:
            y = dist_fn.all_reduce(y, group=self.tp.group)
        return y


class LocalNonLinearBlock(nn.Module):
    """norm → gated block, with a learned 2-way skip. The block kernels'
    operands (``gated_params``) carry the variant's factors folded into the
    scale and the three kernels, so that every variant runs on K3/K4 (JAX
    sends only a "plain" block to its Pallas kernel)."""

    def __init__(self, dim: int, hidden_dim: int, conv_variant: str = "plain",
                 nsubnets: int = 1):
        super().__init__()
        self.nsubnets = nsubnets
        self.skip_weight = nn.Parameter(torch.ones(2))
        self.norm = CustomLayerNorm(dim, conv_variant, nsubnets)
        self.local_linear = LocalGatedLinearBlock(dim, hidden_dim, conv_variant, nsubnets)

    def gated_params(self) -> dict:
        """The block kernels' operands in the JAX layouts: scale (C,), w1
        (C, 2H), dwk (3, 3, 2H), w2 (H, C), skip (2,) (JAX's keys; the kernels
        take ``nsubnets`` beside them); for a "plain" block of one subnet
        views of its parameters, else the folded scale and kernels. A grouped
        block's w1 and w2 are the dense block-diagonal matrices of its
        grouped expand and project (zeros between the subnets, exact), so the
        kernels' GEMMs are unchanged."""
        ll = self.local_linear
        if ll.tp is not None:
            raise RuntimeError("a block split over the model axis has no kernel operands: "
                               "gather the model (parallel.tensor.full_state_dict) to serve it")
        w1, w2 = ll.channels_linear_op.folded(), ll.project_out.folded()
        g = self.nsubnets
        if g == 1:
            w1, w2 = w1[:, :, 0, 0].t(), w2[:, :, 0, 0].t()
        else:
            w1, w2 = cached(ll, (w1, w2), lambda: (block_diagonal(w1, g).t(),
                                                   block_diagonal(w2, g).t()))
        return dict(scale=self.norm.effective_scale(), w1=w1,
                    dwk=ll.channels_local_linear_op.folded()[:, 0].permute(1, 2, 0),
                    w2=w2, skip=self.skip_weight)

    def forward(self, x):
        sw = self.skip_weight
        return sw[0] * x + sw[1] * self.local_linear(self.norm(x))


def block_diagonal(w: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped 1×1 conv's weight (O, I/g, 1, 1) as its dense (O, I)
    matrix: group k's (O/g, I/g) block on the diagonal, zeros elsewhere."""
    o, ig = w.shape[:2]
    return torch.block_diag(*w[:, :, 0, 0].reshape(groups, o // groups, ig))


class RegionalPixelEmbedding(nn.Module):
    """3×3 replicate-pad patch embedding."""

    def __init__(self, c_in: int, dim: int, conv_variant: str = "plain"):
        super().__init__()
        self.channels_local_linear_op01 = Conv3x3Replicate(c_in, dim, variant=conv_variant)

    def forward(self, x):
        return self.channels_local_linear_op01(x)


class LocalLowpassFilteringBlock(nn.Module):
    """One unrolled GGTV+GGLR solve with a learned 0.5/0.5 skip. ``nsubnets``
    is JAX's field, which its solver does not read either."""

    def __init__(self, dim: int, ngraphs: int, *, eval_cg_iters: int = 3,
                 window: str = "cross4", nsubnets: int = 1):
        del nsubnets
        super().__init__()
        self.skip_weight = nn.Parameter(torch.full((2,), 0.5))
        self.local_filter = MixtureGTVGLR(
            n_graphs=ngraphs, n_node_fts=dim // ngraphs,
            eval_cg_iters=eval_cg_iters, window=window)

    def forward(self, x):
        sw = self.skip_weight
        return sw[0] * x + sw[1] * self.local_filter(x)
