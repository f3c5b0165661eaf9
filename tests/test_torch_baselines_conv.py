"""The convolutional baselines in the port against the JAX package: the
block library (``baselines/blocks.py``) and the DnCNN and DRUNet/UNet
families (``baselines/drunet.py``), at small widths (≤ 16 channels, a
block or two a level, ≤ 32×32), on the same seeded numpy input with JAX's
``init`` parameters (jitted) carried across by ``params_to_torch``;
BatchNorms in eval mode with seeded, non-trivial running statistics, and
one in train mode against flax's update of them. The ``dncnn`` snapshot's
layout on the served build. Tolerances: ``atol=1e-4, rtol=1e-3`` per
block, ``atol=1e-3`` per model (ROADMAP's model bar)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.baselines import blocks as jb
from irdu_tpu.models import registry as jax_registry
from irdu_tpu_torch.baselines import blocks as tb
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.predict import BASELINES, DEFAULT_WEIGHTS, build_model
from irdu_tpu_torch.utils.weights import (
    load_params_npz,
    params_from_torch,
    params_to_torch,
)

NC = (8, 16, 16, 16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loud_stats(tree, rng):
    """Running means N(0, 0.1²), variances U[0.5, 1): BN in eval mode then
    moves every channel."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            else:
                node[k] = ((0.1 * rng.randn(*v.shape)) if k == "mean"
                           else (0.5 + 0.5 * rng.rand(*v.shape))).astype(np.float32)
    walk(tree)
    return tree


def jax_variables(module, x, *args, seed=0):
    """JAX's ``init`` at ``x`` (jitted, an "rbg" key: its random bits
    compile in a third of threefry's time), as numpy; batch_stats made
    loud."""
    key = jax.random.key(seed, impl="rbg")
    v = jax.jit(lambda k, a: module.init(k, a, *args))(key, jnp.asarray(x))
    v = jax.tree_util.tree_map(np.array, v)
    if "batch_stats" in v:
        _loud_stats(v["batch_stats"], np.random.RandomState(seed + 7))
    return v


def check(jax_module, port, x, atol, *args, nchw=True):
    """The JAX module at ``x`` (NHWC) against the port's module with its
    parameters (channels-first unless ``nchw`` is False); the JAX tree
    survives the round trip through the port."""
    v = jax_variables(jax_module, x, *args)
    ref = np.asarray(jax.jit(lambda p, a: jax_module.apply(p, a, *args))(v, jnp.asarray(x)))
    params_to_torch(v, port)
    port.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = port(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if nchw else port(xt)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0 if atol == 1e-3 else 1e-3)
    back = params_from_torch(port)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, np.asarray(b, np.float32)), back,
        {k: v[k] for k in back}))
    return out


def _x(h, w, c, seed=0):
    return np.random.RandomState(seed).rand(1, h, w, c).astype(np.float32)


def test_pixel_shuffles_are_jax():
    x = _x(8, 12, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    un = tb.pixel_unshuffle(xt, 2)
    np.testing.assert_array_equal(un.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jb.pixel_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tb.pixel_shuffle(un, 2).numpy(), xt.numpy())
    np.testing.assert_array_equal(
        tb.pixel_shuffle(xt, 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jb.pixel_shuffle(jnp.asarray(x), 2)))


BLOCKS = {  # name: (JAX module, the port's module, input (H, W, C))
    "conv_bn_relu": (lambda: jb.ConvAct(8, use_bn=True),
                     lambda: tb.ConvAct(6, 8, use_bn=True), (10, 12, 6)),
    "conv_dilated_leaky": (lambda: jb.ConvAct(8, act="leaky", dilation=3, use_bias=False),
                           lambda: tb.ConvAct(6, 8, act="leaky", dilation=3, use_bias=False),
                           (10, 12, 6)),
    "conv_stride_sigmoid": (lambda: jb.ConvAct(8, ksize=2, stride=2, padding=0, act="sigmoid"),
                            lambda: tb.ConvAct(6, 8, ksize=2, stride=2, padding=0,
                                               act="sigmoid"), (10, 12, 6)),
    "convtranspose_bn": (lambda: jb.ConvTransposeAct(8, use_bn=True, act="relu"),
                         lambda: tb.ConvTransposeAct(6, 8, use_bn=True, act="relu"),
                         (5, 6, 6)),
    "down_strideconv": (lambda: jb.Downsample(8, act="relu"),
                        lambda: tb.Downsample(6, 8, act="relu"), (10, 12, 6)),
    "down_maxpool": (lambda: jb.Downsample(8, "maxpool"),
                     lambda: tb.Downsample(6, 8, "maxpool"), (10, 12, 6)),
    "down_avgpool_bn": (lambda: jb.Downsample(8, "avgpool", use_bn=True),
                        lambda: tb.Downsample(6, 8, "avgpool", use_bn=True), (10, 12, 6)),
    "up_convtranspose": (lambda: jb.Upsample(8), lambda: tb.Upsample(6, 8), (5, 6, 6)),
    "up_upconv": (lambda: jb.Upsample(8, "upconv", act="relu"),
                  lambda: tb.Upsample(6, 8, "upconv", act="relu"), (5, 6, 6)),
    "up_pixelshuffle": (lambda: jb.Upsample(8, "pixelshuffle", act="leaky"),
                        lambda: tb.Upsample(6, 8, "pixelshuffle", act="leaky"), (5, 6, 6)),
    "imdb": (lambda: jb.IMDBlock(16), lambda: tb.IMDBlock(16), (8, 10, 16)),
    "calayer": (lambda: jb.CALayer(16, 4), lambda: tb.CALayer(16, 4), (8, 10, 16)),
    "rcab": (lambda: jb.RCABlock(16, 4), lambda: tb.RCABlock(16, 4), (8, 10, 16)),
    "rcag": (lambda: jb.RCAGroup(16, 4, nb=2), lambda: tb.RCAGroup(16, 4, nb=2), (8, 10, 16)),
    "rdb": (lambda: jb.ResidualDenseBlock5C(8, gc=4), lambda: tb.ResidualDenseBlock5C(8, gc=4),
            (8, 10, 8)),
    "rrdb": (lambda: jb.RRDB(8, gc=4), lambda: tb.RRDB(8, gc=4), (8, 10, 8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jm, port, (h, w, c) = BLOCKS[name]
    check(jm(), port(), _x(h, w, c, seed=len(name)), 1e-4)


def test_batchnorm_train_step_updates_like_flax():
    """One train-mode forward: the output normalized by the batch's biased
    statistics and the running statistics moved 0.1 of the way to them, as
    flax's ``nn.BatchNorm(momentum=0.9)`` with ``mutable=["batch_stats"]``."""
    x = _x(6, 7, 5, seed=3) * 3 - 1
    jm = jb.ConvAct(4, use_bn=True, act="none")
    v = jax_variables(jm, x)
    ref, new = jax.jit(lambda p, a: jm.apply(p, a, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    port = tb.ConvAct(5, 4, use_bn=True, act="none")
    params_to_torch(v, port)
    out = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-3)
    stats = params_from_torch(port)["batch_stats"]["bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(new["batch_stats"]["bn"][k]),
                                   atol=1e-6, rtol=1e-5)


MODELS = {  # name: (registry name, fields, input (H, W))
    "dncnn_br": ("dncnn", dict(in_nc=3, out_nc=3, nc=8, nb=4, act_mode="BR"), (16, 32)),
    "dncnn_r": ("dncnn", dict(in_nc=3, out_nc=3, nc=8, nb=4, act_mode="R"), (16, 32)),
    "fdncnn": ("fdncnn", dict(in_nc=3, out_nc=3, nc=8, nb=4), (16, 32)),
    "ircnn": ("ircnn", dict(in_nc=3, out_nc=3, nc=8), (16, 32)),
    "drunet": ("drunet", dict(in_nc=3, out_nc=3, nc=NC, nb=1), (16, 32)),
    "unet": ("unet", dict(in_nc=3, out_nc=3, nc=NC, nb=1), (16, 32)),
    "unet_br_pools": ("unet", dict(in_nc=3, out_nc=3, nc=NC, nb=1, act_mode="BL",
                                   downsample_mode="avgpool", upsample_mode="upconv"),
                      (16, 32)),
    "unet_pixelshuffle": ("unet", dict(in_nc=3, out_nc=3, nc=NC, nb=1,
                                       upsample_mode="pixelshuffle"), (16, 32)),
    "resunet": ("resunet", dict(in_nc=3, out_nc=3, nc=NC, nb=1), (13, 21)),
    "unetres_subp": ("unetres_subp", dict(in_nc=3, out_nc=3, nc=NC, nb=1), (16, 32)),
    "unetplus": ("unetplus", dict(in_nc=3, out_nc=3, nc=NC, nb=1), (16, 32)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    """The whole model, f32, JAX's parameters (BN models with loud running
    statistics, eval mode), within 1e-3; resunet on a 13x21 input (its own
    pad to /8 and crop)."""
    kind, kw, (h, w) = MODELS[name]
    out = check(jax_registry.create_model(kind, **kw), registry.create_model(kind, **kw),
                _x(h, w, 3, seed=h + w), 1e-3, nchw=False)
    assert bool(torch.isfinite(out).all())


def test_unetplus_needs_two_char_act_mode():
    with pytest.raises(ValueError, match="2-char"):
        registry.create_model("unetplus", act_mode="R")


def test_dncnn_snapshot_layout():
    """``dncnn_synthetic_2050.npz`` onto predict's "dncnn" build (JAX's
    construction): no leaf without a parameter, no parameter unset."""
    tree = load_params_npz(DEFAULT_WEIGHTS["dncnn"])
    assert BASELINES["dncnn"] == ("dncnn", {"in_nc": 3, "out_nc": 3, "nc": 64, "nb": 17,
                                            "act_mode": "R"})
    model = build_model("dncnn")
    params_to_torch(tree, model)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree)) == 557_443
