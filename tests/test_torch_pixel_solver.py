"""The pixel family's blocks and solver in the port against the JAX package:
the Restormer-style blocks and their flax weight layouts, and MixtureGTV on its
plain, CHW and NHWC routes against JAX's jnp path at tiny widths."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import layers as jlayers
from irdu_tpu.models import restormer_blocks as jblocks
from irdu_tpu.solvers.pixel_gtv import MixtureGTV as JaxMixtureGTV
from irdu_tpu_torch.models import layers, restormer_blocks
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw
from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc
from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.solvers.pixel_gtv import MixtureGTV
from irdu_tpu_torch.utils.weights import params_to_torch


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

BLOCKS = [
    ("conv3x3_zero", lambda: jlayers.Conv3x3Zero(features=5),
     lambda: layers.Conv3x3Zero(3, 5), 3),
    ("depthwise3x3_zero", lambda: jlayers.Conv3x3Zero(features=6, groups=6),
     lambda: layers.Conv3x3Zero(6, 6, groups=6), 6),
    ("channel_var_norm", lambda: jblocks.ChannelVarNorm(7),
     lambda: restormer_blocks.ChannelVarNorm(7), 7),
    ("gdfn", lambda: jblocks.GatedDConvFeedForward(8, 2.6666),
     lambda: restormer_blocks.GatedDConvFeedForward(8, 2.6666), 8),
    ("ffblock", lambda: jblocks.FFBlock(8, 2.6666),
     lambda: restormer_blocks.FFBlock(8, 2.6666), 8),
    ("downsample", lambda: jblocks.Downsample(8), lambda: restormer_blocks.Downsample(8), 8),
    ("upsample", lambda: jblocks.Upsample(8), lambda: restormer_blocks.Upsample(8), 8),
    ("gated_dconv_block", lambda: jblocks.GatedDConvBlock(dim_out=3, hidden_features=24),
     lambda: restormer_blocks.GatedDConvBlock(12, 3, 24), 12),
    ("feature_extraction", lambda: jblocks.FeatureExtraction(
        out_channels=20, dim=8, num_blocks=(1, 2, 1, 1), num_refinement_blocks=2,
        ffn_expansion_factor=2.6666),
     lambda: restormer_blocks.FeatureExtraction(3, 20, 8, (1, 2, 1), 2, 2.6666), 3),
]


@pytest.mark.parametrize("name,jax_block,torch_block,c_in", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_blocks_match_flax(name, jax_block, torch_block, c_in):
    """Each flax block's parameters land on the torch block, which computes
    the same function: NHWC flax apply == NCHW torch forward."""
    x = np.random.RandomState(1).randn(2, 8, 12, c_in).astype(np.float32)
    jb = jax_block()
    params = jb.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if name == "channel_var_norm":  # a scale other than the init's
        params = {"params": {"weighted_transform": np.linspace(0.5, 2.0, c_in, dtype=np.float32)}}
    ref = np.asarray(jb.apply(params, jnp.asarray(x)))
    tb = torch_block()
    params_to_torch(_numpy_tree(params), tb)
    with torch.no_grad():
        out = _nhwc(tb(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# MixtureGTV on each route, tiny widths
# ---------------------------------------------------------------------------

TINY = dict(n_graphs=4, n_node_fts=3, n_cnn_fts=8)


@pytest.fixture(scope="module")
def tiny_mixture():
    """JAX's MixtureGTV (jnp path) at n_cnn_fts=8, blocks (1, 1, 1, 1), with
    μ, ρ and γ raised so that every solver term shows; its output on a seeded
    1x16x36x3 image."""
    jm = JaxMixtureGTV(**TINY, window="diamond12", feature_num_blocks=(1, 1, 1, 1),
                       feature_num_refinement=1)
    x = np.random.RandomState(2).rand(1, 16, 36, 3).astype(np.float32)
    params = _numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(3)
    p = params["params"]
    p["muys00"] = (0.3 + 0.1 * rng.rand(4)).astype(np.float32)
    p["ro00"] = (0.3 + 0.1 * rng.rand(4)).astype(np.float32)
    p["gamma00"] = np.log(0.01 + 0.01 * rng.rand(4)).astype(np.float32)
    for op in ("GTVmodule00", "GLRmodule00"):
        for k in ("stats_p01", "stats_p02a", "stats_p02b", "stats_p03"):
            p[op][k] = (p[op][k] + 0.2 * rng.randn(1)).astype(np.float32)
    return x, params, np.asarray(jm.apply(params, jnp.asarray(x)))


def _tiny_port(params, **flags):
    model = MixtureGTV(**TINY, feature_num_blocks=(1, 1, 1),
                       feature_num_refinement=1, **flags)
    params_to_torch(params, model)
    return model.eval()


ROUTES = {"plain": {}, "chw": dict(use_pallas_unroll=True), "nhwc": dict(use_nhwc_unroll=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_mixture_routes_match_jax_jnp_path(tiny_mixture, route):
    x, params, ref = tiny_mixture
    model = _tiny_port(params, **ROUTES[route])
    assert model.route() == route
    counts = (edge_weights_chw.launches, gg_pixel_unroll_chw.launches,
              pixel_segment_nhwc.launches)
    with torch.no_grad():
        out = _nhwc(model(_nchw(x)))
    assert counts == (edge_weights_chw.launches, gg_pixel_unroll_chw.launches,
                      pixel_segment_nhwc.launches), "CPU tensors must not launch"
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - x).max() > 0.05


@pytest.fixture(scope="module")
def ragged_height(tiny_mixture):
    """A seeded 1x20x36x3 image (H % 8 == 4) and JAX's jnp output on it."""
    _, params, _ = tiny_mixture
    jm = JaxMixtureGTV(**TINY, window="diamond12", feature_num_blocks=(1, 1, 1, 1),
                       feature_num_refinement=1)
    x = np.random.RandomState(4).rand(1, 20, 36, 3).astype(np.float32)
    return x, np.asarray(jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("route", ["chw", "nhwc"])
def test_kernel_routes_take_any_height(tiny_mixture, ragged_height, route):
    """H = 20 fails JAX's band rules (H % 16 for NHWC, H % 8 for CHW), so JAX
    runs its jnp path; the port keeps the kernel route its flag names, with
    the same result."""
    _, params, _ = tiny_mixture
    x, ref = ragged_height
    model = _tiny_port(params, **ROUTES[route])
    assert model.route() == route
    with torch.no_grad():
        out = _nhwc(model(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - x).max() > 0.05


def test_chw_route_above_the_cap_raises(tiny_mixture, monkeypatch):
    """Above the cap the CHW route runs K5 in the pixel mode (6 band steps),
    as JAX's does; it raised until that mode was ported (the name stays).
    Now it computes JAX's jnp result, and launches nothing from the CPU."""
    x, params, ref = tiny_mixture
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 16 * 36 - 1)
    model = _tiny_port(params, use_pallas_unroll=True)
    counts = (gg_pixel_unroll_chw.launches, gg_fused_step_chw.launches)
    with torch.no_grad():
        out = _nhwc(model(_nchw(x)))
    assert counts == (gg_pixel_unroll_chw.launches, gg_fused_step_chw.launches)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
