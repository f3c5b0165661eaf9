"""The pixel model's ``stats_mode="none"`` and ``feature_n_levels=4``
against the JAX package in f32 with JAX's parameters carried across, and
the kernels the no-stencil core takes; a file of its own so that a worker
per file runs it beside test_torch_variants.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.pixel import MultiScaleSequenceDenoiser as JaxPixel
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.solvers import pixel_gtv
from irdu_tpu_torch.utils.weights import params_to_torch
from test_torch_variants import one_torch_thread, TOL, _variables


PIXEL = dict(n_graphs=3, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
             feature_num_refinement=1)
OPTIONS = {"no_stats": dict(stats_mode="none"), "four_levels": dict(feature_n_levels=4),
           "v4": dict(stats_mode="none", feature_n_levels=4)}
FLAGS = {"plain": {}, "chw": dict(use_pallas_solver=True),
         "served": dict(use_pallas_solver=True, use_nhwc_solver=True)}
# the unroll's calls per route: K2 once on 2G graphs, then K7 or the K8 unroll
ROUTE_CALLS = {"plain": [], "chw": ["edge_weights_chw", "gg_pixel_unroll_chw"],
               "served": ["edge_weights_chw", "pixel_unroll_nhwc"]}


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_pixel_option_matches_jax(option, flags):
    """Each option on a small pixel model, with the solver flags off, on the
    CHW route and as predict serves the family (NHWC), against JAX's jnp
    path."""
    x = np.random.RandomState(9).rand(1, 16, 24, 3).astype(np.float32)
    jm = JaxPixel(**PIXEL, **OPTIONS[option])
    v = _variables(jm, np.zeros_like(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = MultiScaleSequenceDenoiser(**PIXEL, **OPTIONS[option], **FLAGS[flags])
    params_to_torch(v, port)
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_no_stencil_core_takes_the_kernel_routes(flags, monkeypatch):
    """stats_mode="none" keeps the route its flags name: with a kernel flag,
    K2 for the weights and K7 (CHW) or the K8 unroll (NHWC), the stencil
    the identity; with neither, the plain versions alone."""
    calls = []
    for name in ("edge_weights_chw", "gg_pixel_unroll_chw", "pixel_unroll_nhwc",
                 "gg_fused_step_chw"):
        real = getattr(pixel_gtv, name)
        monkeypatch.setattr(pixel_gtv, name,
                            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    port = MultiScaleSequenceDenoiser(**PIXEL, stats_mode="none", **FLAGS[flags])
    mix = port.mixtureGLR_block03
    assert mix.route() == {"served": "nhwc"}.get(flags, flags)
    assert not hasattr(mix.GTVmodule00, "stats_p01")
    assert mix.GTVmodule00.stats_scalars().tolist() == [1.0, 0.0, 0.0, 0.0]
    with torch.inference_mode():
        port(torch.rand(1, 16, 16, 3))
    assert calls == ROUTE_CALLS[flags]


def test_v4_pixel_config_matches_jax():
    """configs/lightformer_pixel_v4.yaml's model at its widths (16 graphs,
    48 features, 4 levels, no stencil) as served, against JAX at 16x16."""
    kw = dict(n_graphs=16, n_node_fts=3, n_cnn_fts=48, window="diamond12", stats_mode="none",
              feature_n_levels=4)
    x = np.random.RandomState(10).rand(1, 16, 16, 3).astype(np.float32)
    jm = JaxPixel(**kw)
    v = _variables(jm, np.zeros_like(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = MultiScaleSequenceDenoiser(**kw, **FLAGS["served"])
    params_to_torch(v, port)
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
