"""The attention baselines in the port against the JAX package: Restormer
(``baselines/restormer.py``: both LayerNorms, MDTA, GDFN, a transformer
block, the model with and without biases, the dual-pixel head, remat),
SwinIR (``baselines/swinir.py``: the window helpers, the shift mask,
window attention with its mask, a shifted block, the model) and the
non-local block and U-Net (``baselines/blocks.py``, ``drunet.py``), at small
widths on the same seeded numpy input with JAX's ``init`` parameters
(jitted) carried across by ``params_to_torch``. Tolerances: ``atol=1e-4,
rtol=1e-3`` per block, ``atol=1e-3`` per model."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.baselines import blocks as jax_blocks
from irdu_tpu.baselines import restormer as jr
from irdu_tpu.baselines import swinir as js
from irdu_tpu.models import registry as jax_registry
from irdu_tpu_torch.baselines import blocks as tb
from irdu_tpu_torch.baselines import restormer as tr
from irdu_tpu_torch.baselines import swinir as ts
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.utils.weights import params_from_torch, params_to_torch

TINY_RESTORMER = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                      heads=(1, 2, 2, 4), norm_type="BiasFree")
TINY_SWINIR = dict(embed_dim=12, depths=(2, 2), num_heads=(2, 3), window_size=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def check(jax_module, port, x, atol, jax_args=(), port_args=(), layout="nhwc", loud=None):
    """The JAX module at ``x`` against the port's module with JAX's
    parameters (``init`` jitted with an "rbg" key, which compiles faster
    than threefry's; ``loud`` may rewrite them). ``layout``: "nchw" (the
    port's module is channels-first, the JAX one NHWC), "nhwc" or "tokens"
    (both take the same array). The JAX tree survives the round trip."""
    v = jax.jit(lambda k, a: jax_module.init(k, a, *jax_args))(
        jax.random.key(0, impl="rbg"), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.array, v)
    if loud:
        loud(v["params"])
    ref = np.asarray(jax.jit(lambda p, a: jax_module.apply(p, a, *jax_args))(v, jnp.asarray(x)))
    params_to_torch(v, port)
    port.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if layout == "nchw":
            out = port(xt.permute(0, 3, 1, 2), *port_args).permute(0, 2, 3, 1)
        else:
            out = port(xt, *port_args)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0 if atol == 1e-3 else 1e-3)
    back = params_from_torch(port)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, np.asarray(b, np.float32)), back,
        {k: v[k] for k in back}))
    return out


def _loud_norm(params):
    """Norm scales and biases and the heads' temperatures away from 1 and 0."""
    rng = np.random.RandomState(5)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("weight", "bias", "temperature"):
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    walk(params)


RESTORMER_BLOCKS = {
    "layernorm_biasfree": (lambda: jr.RestormerLayerNorm(8, "BiasFree"),
                           lambda: tr.RestormerLayerNorm(8, "BiasFree")),
    "layernorm_withbias": (lambda: jr.RestormerLayerNorm(8, "WithBias"),
                           lambda: tr.RestormerLayerNorm(8, "WithBias")),
    "mdta": (lambda: jr.MDTA(8, 2), lambda: tr.MDTA(8, 2)),
    "mdta_bias": (lambda: jr.MDTA(8, 4, use_bias=True), lambda: tr.MDTA(8, 4, use_bias=True)),
    "gdfn": (lambda: jr.RestormerFeedForward(8), lambda: tr.RestormerFeedForward(8)),
    "transformer_block": (lambda: jr.TransformerBlock(8, 2, norm_type="BiasFree"),
                          lambda: tr.TransformerBlock(8, 2, norm_type="BiasFree")),
}


@pytest.mark.parametrize("name", sorted(RESTORMER_BLOCKS))
def test_restormer_block_matches_jax(name):
    """The biased variance (the BiasFree norm keeps the mean in its output),
    MDTA's per-head C×C attention with L2-normalized q, k and its
    temperature, the erf-GELU GDFN."""
    jm, port = RESTORMER_BLOCKS[name]
    check(jm(), port(), _x((1, 6, 10, 8), seed=len(name)) * 2 - 0.5, 1e-4, layout="nchw",
          loud=_loud_norm)


RESTORMERS = {  # the served configuration; every other option at once
    "biasfree": TINY_RESTORMER,
    "withbias_bias_dual_pixel": dict(TINY_RESTORMER, norm_type="WithBias", use_bias=True,
                                     dual_pixel_task=True),
}


@pytest.mark.parametrize("name", sorted(RESTORMERS))
def test_restormer_matches_jax(name):
    kw = RESTORMERS[name]
    check(jax_registry.create_model("restormer", **kw), registry.create_model("restormer", **kw),
          _x((1, 16, 24, 3)), 1e-3, loud=_loud_norm)


def test_restormer_remat_keeps_values_and_gradients():
    """``set_remat`` (JAX's ``remat`` field) recomputes the blocks in the
    backward pass: the same output and gradients, the same names."""
    torch.manual_seed(0)
    model = registry.create_model("restormer", **TINY_RESTORMER)
    x = torch.from_numpy(_x((1, 16, 16, 3)))
    grads = []
    for on in (False, True):
        registry.set_remat(model, on)
        model.zero_grad()
        out = model(x)
        out.square().sum().backward()
        grads.append((out.detach(), [p.grad.clone() for p in model.parameters()]))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    assert registry.create_model("restormer", remat=True, **TINY_RESTORMER).remat


def test_swin_helpers_are_jax():
    """window_partition/reverse, the relative position index (a buffer, not
    a parameter) and the shift mask (−100 between regions) equal JAX's."""
    x = _x((2, 8, 12, 5))
    wp = ts.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(js.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(ts.window_reverse(wp, 4, 8, 12).numpy(), x)
    np.testing.assert_array_equal(ts.relative_position_index(4), js.relative_position_index(4))
    mask = ts.make_shift_mask(8, 12, 4, 2)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(js.make_shift_mask(8, 12, 4, 2)))
    assert set(np.unique(mask.numpy())) == {-100.0, 0.0}
    attn = ts.WindowAttention(12, 4, 3)
    assert "relative_position_index" not in dict(attn.named_parameters())
    assert "relative_position_index" in dict(attn.named_buffers())


def _loud_swin(params):
    """LayerNorm scales and biases and the position bias table spread."""
    rng = np.random.RandomState(6)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "relative_position_bias_table"):
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k == "bias" and v.ndim == 1:
                node[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
    walk(params)


def test_window_attention_with_mask_matches_jax():
    h, w, ws = 8, 12, 4
    mask_j = js.make_shift_mask(h, w, ws, 2)
    x = _x((h * w // ws // ws, ws * ws, 12), seed=2) * 2 - 1
    check(js.WindowAttention(12, ws, 3), ts.WindowAttention(12, ws, 3), x, 1e-4,
          jax_args=(mask_j,), port_args=(ts.make_shift_mask(h, w, ws, 2),), layout="tokens",
          loud=_loud_swin)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_matches_jax(shift):
    h, w, ws = 8, 12, 4
    x = _x((1, h * w, 12), seed=3) * 2 - 1
    check(js.SwinBlock(12, 3, ws, shift), ts.SwinBlock(12, 3, ws, shift), x, 1e-4,
          jax_args=(h, w, js.make_shift_mask(h, w, ws, 2)),
          port_args=(h, w, ts.make_shift_mask(h, w, ws, 2)), layout="tokens", loud=_loud_swin)


def test_swinir_matches_jax():
    out = check(jax_registry.create_model("swinir", **TINY_SWINIR),
                registry.create_model("swinir", **TINY_SWINIR), _x((1, 8, 16, 3), seed=4),
                1e-3, loud=_loud_swin)
    assert bool(torch.isfinite(out).all())


def test_swinir_input_off_the_window_raises():
    model = registry.create_model("swinir", **TINY_SWINIR)
    with pytest.raises(ValueError, match="multiples of its window 4"):
        model(torch.zeros(1, 8, 10, 3))


def test_nonlocal_block_matches_jax():
    """softmax(θφᵀ)·g over all pixels, W with BatchNorm (eval mode, seeded
    running statistics), + x; also with φ and g downsampled."""
    for down in (False, True):
        jm = jax_blocks.NonLocalBlock2D(8, downsample=down)
        port = tb.NonLocalBlock2D(8, downsample=down)
        x = _x((1, 6, 10, 8), seed=7)
        v = jax.jit(jm.init)(jax.random.key(1, impl="rbg"), jnp.asarray(x))
        v = jax.tree_util.tree_map(np.array, v)
        rng = np.random.RandomState(8)
        v["batch_stats"]["w"]["bn"] = {"mean": (0.1 * rng.randn(8)).astype(np.float32),
                                       "var": (0.5 + rng.rand(8)).astype(np.float32)}
        v["params"]["w"]["bn"]["scale"] = (0.5 + rng.rand(8)).astype(np.float32)
        ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
        params_to_torch(v, port)
        with torch.no_grad():
            out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)
        assert np.abs(ref - x).max() > 1e-2


def test_nonlocal_unet_matches_jax():
    kw = dict(in_nc=3, out_nc=3, nc=(8, 8, 16, 16), nb=1)
    check(jax_registry.create_model("nonlocal_unet", **kw),
          registry.create_model("nonlocal_unet", **kw), _x((1, 16, 32, 3), seed=9), 1e-3)
