"""The flagship's ``conv_variant`` (spectral norm, non-expansive) against
the JAX package in f32 with JAX's parameters and "spectral" collection
carried across, layer by layer; the factors folded into the block
kernels' operands; and the 86k snapshot's cg1. The small flagship under each variant is in
test_torch_variants_flagship.py, the pixel model's options in
test_torch_variants_pixel.py (files of their own, so that a worker per file
runs them side by side); they import the helpers here."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import blocks as jax_blocks
from irdu_tpu.models import layers as jax_layers
from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models.flagship import flagship_config
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.models import blocks, flagship, layers
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, load_model
from irdu_tpu_torch.utils.weights import params_to_torch

VARIANTS = ("non_expansive", "spectral_norm")
TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them as fast, and
    the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jitter(tree, rs):
    """Every parameter scaled by 1 + 0.3·N(0, 1): the inits' ones (skips,
    scaling factors) and constants would hide a leaf carried to the wrong place."""
    return {k: _jitter(v, rs) if isinstance(v, dict)
            else (np.asarray(v) * (1 + 0.3 * rs.randn(*np.shape(v)))).astype(np.float32)
            for k, v in tree.items()}


def _variables(module, x, seed=1):
    """JAX's init at x's shape (the spectral u vectors from its PRNGKey(0)
    default), the params jittered."""
    v = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return {**v, "params": _jitter(v["params"], np.random.RandomState(seed))}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_numpy_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


LAYERS = {
    "pointwise": (lambda v: jax_layers.GroupedPointwise(features=12, variant=v),
                  lambda v: layers.GroupedPointwise(8, 12, variant=v), 8),
    "conv3x3": (lambda v: jax_layers.Conv3x3Replicate(features=6, variant=v),
                lambda v: layers.Conv3x3Replicate(5, 6, variant=v), 5),
    "depthwise": (lambda v: jax_layers.Conv3x3Replicate(features=8, groups=8, variant=v),
                  lambda v: layers.Conv3x3Replicate(8, 8, groups=8, variant=v), 8),
    "downsample": (lambda v: jax_layers.Downsample2x2(features=10, variant=v),
                   lambda v: layers.Downsample2x2(6, 10, variant=v), 6),
    "upsample": (lambda v: jax_layers.Upsample2x2(features=5, variant=v),
                 lambda v: layers.Upsample2x2(7, 5, variant=v), 7),
    "norm": (lambda v: jax_blocks.CustomLayerNorm(9, conv_variant=v),
             lambda v: blocks.CustomLayerNorm(9, conv_variant=v), 9),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_variant_matches_jax(layer, variant):
    """Each conv and the norm under each variant, JAX's parameters and u
    vector carried across (the u rows of the up-sample follow flax's
    (a·2+b)·O + o order)."""
    make_jax, make_port, c_in = LAYERS[layer]
    x = np.random.RandomState(2).randn(2, 6, 10, c_in).astype(np.float32)
    jm = make_jax(variant)
    v = _variables(jm, x)
    if variant == "spectral_norm" and layer != "norm":
        assert "kernel_u" in v["spectral"]
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = make_port(variant)
    params_to_torch(v, port)
    out = _to_numpy_nhwc(port(_nchw(x)))
    np.testing.assert_allclose(out, ref, **TOL)


def test_spectral_u_is_carried_and_used():
    """The stored u enters σ: another u gives another output, so a parity
    test could not pass with the port's own u."""
    x = np.random.RandomState(3).randn(1, 4, 4, 8).astype(np.float32)
    jm = jax_layers.GroupedPointwise(features=6, variant="spectral_norm")
    v = _variables(jm, x)
    port = layers.GroupedPointwise(8, 6, variant="spectral_norm")
    params_to_torch(v, port)
    np.testing.assert_allclose(port.kernel_u.numpy(), v["spectral"]["kernel_u"])
    first = port(_nchw(x))
    with torch.no_grad():
        port.kernel_u.copy_(torch.ones(6) / np.sqrt(6))
    assert (port(_nchw(x)) - first).abs().max() > 1e-4


SMALL = dict(dims=(16, 16, 32, 32), hidden_dims=(16, 32, 32, 64), ngraphs=(2, 2, 4, 4),
             num_blocks=(2, 1, 1, 1), num_blocks_out=1)


@pytest.mark.parametrize("variant", ("plain", *VARIANTS))
def test_every_variant_takes_the_block_kernels(variant, monkeypatch):
    """The variant's factors are folded into the block kernels' operands,
    so a spectral or non-expansive block takes K3 and K4 as a plain one
    does (stand-ins count the calls), where JAX runs it on XLA."""
    calls = []

    def stand_in(name, real):
        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    monkeypatch.setattr(flagship, "fused_block_stack",
                        stand_in("K3", flagship.fused_block_stack))
    monkeypatch.setattr(flagship, "fused_gated_block",
                        stand_in("K4", flagship.fused_gated_block))
    widths = dict(dims=(16, 96, 96, 96), hidden_dims=(16, 96, 96, 96))  # K3 and K4 both
    model = AbstractMultiScaleGraphFilter(conv_variant=variant, **{**SMALL, **widths})
    with torch.inference_mode():
        model(torch.rand(1, 32, 32, 3))
    assert sorted(set(calls)) == ["K3", "K4"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_folded_block_operands_match_the_block(variant):
    """K4's plain version on a block's folded operands (scale, w1, dwk, w2)
    against the block's own PyTorch ops, which apply σ and the gain per
    conv: the fold is exact up to rounding."""
    torch.manual_seed(5)
    block = blocks.LocalNonLinearBlock(12, 10, variant).requires_grad_(False)
    with torch.no_grad():
        for p in block.parameters():
            p.mul_(1 + 0.3 * torch.randn(p.shape))
    x = torch.randn(2, 12, 9, 11)
    with torch.inference_mode():
        want = block(x)
        got = flagship.fused_gated_block(x, **block.gated_params())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_folded_kernel_is_kept_until_a_source_changes(variant):
    """A model autograd does not record folds its kernels once; a write to
    the weight or to u / the scaling factor folds them again, and a module
    that autograd records folds on every call."""
    conv = layers.Conv3x3Replicate(6, 6, variant=variant).requires_grad_(False)
    extra = conv.kernel_u if variant == "spectral_norm" else conv.scaling_factor
    x = torch.randn(1, 6, 7, 5)
    with torch.inference_mode():
        first = conv.folded()
        assert conv.folded() is first
    for t in (conv.weight, extra):
        with torch.no_grad():
            t.copy_(t * (1.5 + torch.rand(t.shape)))
        fresh = layers.Conv3x3Replicate(6, 6, variant=variant)
        fresh.load_state_dict(conv.state_dict())
        with torch.no_grad():
            torch.testing.assert_close(conv(x), fresh(x), atol=0, rtol=0)
    conv.requires_grad_(True)
    assert conv.folded() is not conv.folded()


def test_flagship_cg1_matches_jax():
    """The 86k snapshot with one CG step (the curve's cg1 variant, which has
    no JAX protocol number) against JAX at 32x32."""
    x = np.random.RandomState(8).rand(1, 32, 32, 3).astype(np.float32)
    params = jax_load(DEFAULT_WEIGHTS["flagship"], dtype=jnp.float32)
    ref = np.asarray(JaxFlagship(eval_cg_iters=1, **flagship_config()).apply(params,
                                                                          jnp.asarray(x)))
    with torch.inference_mode():
        out = load_model(device="cpu", cg_iters=1)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
