"""Layers of the flagship and the pixel family, channels-first (B, C, H, W).

Weights are stored in PyTorch's conv layouts; ``kernel_to_torch`` converts the
JAX package's flax kernel of the same layer, and ``kernel_from_torch`` back
(counterpart: ``irdu_tpu/models/layers.py``; g channel groups, a group's
input and output channels contiguous, as torch's ``groups`` has them):

  GroupedPointwise  flax (I, O/g), row gi·I/g + i      → conv2d (O, I/g, 1, 1)
  Conv3x3Replicate  flax HWIO (3, 3, I/g, O)           → conv2d (O, I/g, 3, 3)
  Conv3x3Zero       the same
  Downsample2x2     flax (4I, O/g), row (a·2+b)·I + i  → conv2d (O, I/g, 2, 2)
  Upsample2x2       flax (I, 4O/g), col (a·2+b)·O/g+o  → conv_transpose2d (I, O/g, 2, 2)

Initialization follows torch's Conv2d default, U(±1/√fan_in), as the JAX
package does.

``variant`` (the flagship's ``conv_variant``; one channel group):

  "plain"          the conv as it stands;
  "spectral_norm"  the kernel divided by σ, its top singular value estimated
                   by one power iteration from the buffer ``kernel_u`` (JAX's
                   "spectral" collection, ``{name}_u``), which inference leaves
                   as it is (JAX's collection is immutable there);
  "non_expansive"  the output scaled by tanh(1/(|W|∗1 · s + 1e-16)), |W|∗1 the
                   conv of |kernel| with a ones input, s the learned per-output
                   ``scaling_factor``.

Both factors are constant per output channel (and, for the up-sample, per
output phase), so ``folded()`` multiplies them into the kernel, and the
blocks hand the folded kernels to K3/K4 as a plain block's. JAX's grouped
down/up samples (g > 1) apply no non-expansive factor and have no
``scaling_factor``: the port builds them so. A grouped kernel's σ is that
of JAX's (O/g, everything else) matricization, its ``kernel_u`` O/g long
(4·O/g for the up-sample), its non-expansive gain the sum of |W| over the
output's I/g inputs. A model that
autograd does not record keeps its folded kernels (``cached``) until a
weight, u or scaling factor changes.

σ is computed on JAX's matricization (O, everything else) of the flax
kernel; a permutation of its columns leaves σ as it is, so only the row
order, which ``kernel_u`` indexes, follows flax (``Upsample2x2``: rows
(a·2+b)·O + o). The pixel family's PixelShuffle and PixelUnshuffle are
``F.pixel_shuffle`` and ``F.pixel_unshuffle``: in NCHW they order channels
as the JAX package's ``pixel_shuffle``/``pixel_unshuffle`` do (c·r² + a·r + b).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from irdu_tpu_torch.kernels import library


VARIANTS = ("plain", "spectral_norm", "non_expansive")


def uniform_param(shape, fan_in):
    """A parameter drawn from U(±1/√fan_in), torch's Conv2d default."""
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


def spectral_normalize(weight: torch.Tensor, mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``weight`` / σ, σ = uᵀ·M·v with v = Mᵀu/‖Mᵀu‖ (one power iteration
    from the stored u, in f32; u is not updated). ``mat``: the kernel's
    matricization (O, ·) with JAX's row order."""
    mat, u = mat.float(), u.float()
    v = mat.t() @ u
    v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    sigma = torch.clamp(torch.dot(u, mat @ v), min=1e-12)
    return weight / sigma.to(weight.dtype)


def non_expansive_scale(norm: torch.Tensor, scaling_factor: torch.Tensor) -> torch.Tensor:
    """tanh(1/(|W|∗1 · s + 1e-16)), ``norm`` (|W|∗1) and ``scaling_factor``
    shaped to broadcast against each other."""
    return torch.tanh(1.0 / (norm * scaling_factor + 1e-16))


def cached(owner: nn.Module, sources, compute):
    """``compute()``, kept on ``owner`` while every tensor of ``sources``
    keeps its storage and its version (a write through ``.data`` is not
    seen). Computed afresh where autograd records a source, and for
    inference tensors, which have no version, and in a trace, whose tensors
    have no storage. The entry holds the sources, so that a new tensor cannot
    take their memory and their key."""
    if (library.tracing() or any(t.is_inference() for t in sources)
            or torch.is_grad_enabled() and any(t.requires_grad for t in sources)):
        return compute()
    key = [(t.data_ptr(), t._version) for t in sources]
    entry = owner.__dict__.get("_cached")
    if entry is None or entry[0] != key:
        entry = owner.__dict__["_cached"] = (key, tuple(sources), compute())
    return entry[2]


def remat_call(module: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``module(x)``; with ``remat`` and grad enabled, through
    ``torch.utils.checkpoint`` (non-reentrant): the activations inside are
    not kept but recomputed in the backward pass, as JAX's ``nn.remat``
    does. The values and the gradients are the same; the module's
    parameter names are untouched."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, x, use_reentrant=False)
    return module(x)


class VariantConv(nn.Module):
    """The ``variant`` machinery shared by the flagship's convs: a subclass
    sets ``weight``, ``OUT_DIM`` (the weight's output-channel dim) and, where
    they differ from a conv2d's, ``rows`` (the flax matricization's rows) and
    ``gain`` (|W|∗1 per output, shaped to broadcast over the weight)."""

    OUT_DIM = 0
    groups = 1
    shard = None  # (Placement, ModelShard) where the model axis splits the weight

    def _variant(self, variant: str, n_rows: int, features: int):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        self.variant = variant
        if variant == "spectral_norm":
            # JAX draws u ~ N(0, 1/O) from its PRNGKey(0); a JAX model's u is
            # carried across by utils.weights.params_to_torch(spectral=...)
            gen = torch.Generator().manual_seed(0)
            self.register_buffer("kernel_u", torch.randn(n_rows, generator=gen)
                                 / math.sqrt(n_rows))
        elif variant == "non_expansive":
            self.scaling_factor = nn.Parameter(torch.ones(features))

    def folded(self) -> torch.Tensor:
        """The kernel with the variant's factor in it, in the weight's dtype:
        W/σ, or W times the non-expansive scale of its output; a plain
        conv's weight itself."""
        if self.variant == "plain":
            return self.weight
        if self.shard is not None:
            # a slice of the weight (tensor parallel): σ and the gain read the
            # whole kernel, gathered from the model group, then sliced again
            from irdu_tpu_torch.parallel.tensor import gather_full, local_part

            pl, shard = self.shard
            return local_part(self._fold(gather_full(self.weight, pl, shard)), pl, shard)
        extra = self.kernel_u if self.variant == "spectral_norm" else self.scaling_factor
        return cached(self, (self.weight, extra), lambda: self._fold(self.weight))

    def _fold(self, w: torch.Tensor) -> torch.Tensor:
        if self.variant == "spectral_norm":
            return spectral_normalize(w, self.rows(w), self.kernel_u)
        s = self.scaling_factor.float().reshape([-1 if d == self.OUT_DIM else 1 for d in range(4)])
        return (w.float() * non_expansive_scale(self.gain(w), s)).to(w.dtype)

    def rows(self, w: torch.Tensor) -> torch.Tensor:  # (O, ·) in JAX's row order
        return w.reshape(w.shape[0], -1)

    def gain(self, w: torch.Tensor) -> torch.Tensor:  # |W|∗1 per output channel, (O, 1, 1, 1)
        return w.abs().float().sum(dim=(1, 2, 3), keepdim=True)


class GroupedPointwise(VariantConv):
    """1×1 conv in ``groups`` channel groups, no bias unless ``use_bias``
    (U(±1/√fan_in), fan_in = c_in / groups, as the kernel)."""

    def __init__(self, c_in: int, features: int, variant: str = "plain",
                 use_bias: bool = False, groups: int = 1):
        super().__init__()
        self.groups = groups
        fan_in = c_in // groups
        self.weight = uniform_param((features, fan_in, 1, 1), fan_in)
        self.bias = uniform_param((features,), fan_in) if use_bias else None
        self._variant(variant, features // groups, features)

    def kernel_to_torch(self, k: torch.Tensor) -> torch.Tensor:
        g = self.groups
        c_in, og = k.shape
        return k.reshape(g, c_in // g, og).transpose(1, 2).reshape(g * og, c_in // g)[
            :, :, None, None]

    def kernel_from_torch(self, w: torch.Tensor) -> torch.Tensor:
        g = self.groups
        o, ig = w.shape[:2]
        return w[:, :, 0, 0].reshape(g, o // g, ig).transpose(1, 2).reshape(g * ig, o // g)

    def rows(self, w):  # JAX's (O/g, I) matricization
        return self.kernel_from_torch(w).t()

    def forward(self, x):
        return F.conv2d(x, self.folded(), self.bias, groups=self.groups)


class Conv3x3Replicate(VariantConv):
    """3×3 stride-1 conv with replicate padding, no bias. Under replicate
    padding a ones input stays ones, so the non-expansive gain Σ|W| is
    constant over space."""

    def __init__(self, c_in: int, features: int, groups: int = 1, variant: str = "plain"):
        super().__init__()
        self.groups = groups
        self.weight = uniform_param((features, c_in // groups, 3, 3), c_in // groups * 9)
        self._variant(variant, features, features)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        return k.permute(3, 2, 0, 1)

    @staticmethod
    def kernel_from_torch(w: torch.Tensor) -> torch.Tensor:
        return w.permute(2, 3, 1, 0)

    def forward(self, x):
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), self.folded(),
                        groups=self.groups)


def _grouped_variant(variant: str, groups: int) -> str:
    """JAX's grouped down/up samples skip the non-expansive factor (and make
    no ``scaling_factor``); spectral norm applies at any group count."""
    return "plain" if groups > 1 and variant == "non_expansive" else variant


class Downsample2x2(VariantConv):
    """Learned 2×2 stride-2 conv in ``groups`` channel groups, no bias."""

    def __init__(self, c_in: int, features: int, variant: str = "plain", groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = uniform_param((features, c_in // groups, 2, 2), c_in // groups * 4)
        self._variant(_grouped_variant(variant, groups), features // groups, features)

    def kernel_to_torch(self, k: torch.Tensor) -> torch.Tensor:
        g = self.groups
        four_i, og = k.shape
        ig = four_i // 4 // g
        return k.reshape(2, 2, g, ig, og).permute(2, 4, 3, 0, 1).reshape(g * og, ig, 2, 2)

    def kernel_from_torch(self, w: torch.Tensor) -> torch.Tensor:
        g = self.groups
        o, ig = w.shape[:2]
        return w.reshape(g, o // g, ig, 2, 2).permute(3, 4, 0, 2, 1).reshape(4 * g * ig, o // g)

    def rows(self, w):  # JAX's (O/g, 4I) matricization
        return self.kernel_from_torch(w).t()

    def forward(self, x):
        return F.conv2d(x, self.folded(), stride=2, groups=self.groups)


class Upsample2x2(VariantConv):
    """Learned 2×2 stride-2 transpose conv in ``groups`` channel groups, no
    bias. JAX's kernel is (I, 4·O/g) with columns (a·2+b)·O/g + o, so its
    spectral rows are 4·O/g and its non-expansive gain (one group) is per
    output channel and phase (a, b): output pixel (2h + a, 2w + b) takes tap
    (a, b) alone, so the gain folds into it."""

    def __init__(self, c_in: int, features: int, variant: str = "plain", groups: int = 1):
        super().__init__()
        self.groups = groups
        og = features // groups
        # torch's conv_transpose init takes fan_in from the output side
        self.weight = uniform_param((c_in, og, 2, 2), og * 4)
        self._variant(_grouped_variant(variant, groups), 4 * og, features)

    @staticmethod
    def kernel_to_torch(k: torch.Tensor) -> torch.Tensor:
        i, four_o = k.shape
        return k.reshape(i, 2, 2, four_o // 4).permute(0, 3, 1, 2)

    @staticmethod
    def kernel_from_torch(w: torch.Tensor) -> torch.Tensor:
        return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)

    OUT_DIM = 1

    def rows(self, w):
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])

    def gain(self, w):  # (1, O, 2, 2): output channel o, phase (a, b), one tap each
        return w.abs().float().sum(dim=0, keepdim=True)

    def forward(self, x):
        return F.conv_transpose2d(x, self.folded(), stride=2, groups=self.groups)


class Conv3x3Zero(nn.Module):
    """3×3 stride-1 conv with zero padding (torch Conv2d padding=1), no bias
    unless ``use_bias``; the pixel family's feature U-Net and DC estimator,
    Restormer, SwinIR and DRUNet use it. Same flax kernel layout as
    ``Conv3x3Replicate``."""

    def __init__(self, c_in: int, features: int, groups: int = 1, use_bias: bool = False):
        super().__init__()
        self.groups = groups
        fan_in = c_in // groups * 9
        self.weight = uniform_param((features, c_in // groups, 3, 3), fan_in)
        self.bias = uniform_param((features,), fan_in) if use_bias else None

    kernel_to_torch = staticmethod(Conv3x3Replicate.kernel_to_torch)
    kernel_from_torch = staticmethod(Conv3x3Replicate.kernel_from_torch)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=1, groups=self.groups)
