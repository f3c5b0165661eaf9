"""The pixel family's model on the cross-4 and ring-8 windows against the JAX
package, and the skip-solve probe: a small ``multiscale_sequence_denoiser``
(JAX's init, every parameter carried over, the solver's μ, ρ, γ and
stencils moved off their inits) on its plain, CHW and NHWC routes against JAX's model
(its jnp path) at ``atol=1e-3``; ``eval_skip_solve`` against JAX's with no
solver kernel called; ``n_cgd_iters != 4`` refused by both packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.pixel import MultiScaleSequenceDenoiser as JaxPixel
from irdu_tpu.solvers.pixel_gtv import MixtureGTV as JaxMixtureGTV
from irdu_tpu_torch.models.registry import create_model
from irdu_tpu_torch.ops.windows import WINDOWS
from irdu_tpu_torch.solvers import pixel_gtv
from irdu_tpu_torch.utils.weights import params_to_torch

SMALL = dict(n_graphs=4, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
             feature_num_refinement=1)
ROUTES = {"plain": {}, "chw": dict(use_pallas_solver=True),
          "nhwc": dict(use_nhwc_solver=True)}
SOLVER_KERNELS = ("edge_weights_chw", "gg_pixel_unroll_chw", "gg_fused_step_chw",
                  "pixel_unroll_nhwc", "pixel_unroll_plain")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_params():
    """JAX's small model's init (its parameters do not depend on the window:
    multiM is (G, F), the stencils scalars), μ, ρ U(0.1, 0.15) (the init's
    0.1; at 0.35 the small model's unroll diverges on cross-4), γ U(0.01,
    0.02) and the stencils moved off their inits; a seeded 1x16x36x3
    image."""
    x = np.random.RandomState(2).rand(1, 16, 36, 3).astype(np.float32)
    key = jax.random.key(0, impl="rbg")
    params = jax.jit(JaxPixel(**SMALL).init)(key, jnp.zeros_like(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    p = params["params"]["mixtureGLR_block03"]
    rng = np.random.RandomState(3)
    p["muys00"] = (0.1 + 0.05 * rng.rand(4)).astype(np.float32)
    p["ro00"] = (0.1 + 0.05 * rng.rand(4)).astype(np.float32)
    p["gamma00"] = np.log(0.01 + 0.01 * rng.rand(4)).astype(np.float32)
    for op in ("GTVmodule00", "GLRmodule00"):
        for k in ("stats_p01", "stats_p02a", "stats_p02b", "stats_p03"):
            p[op][k] = (p[op][k] + 0.2 * rng.randn(1)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module", params=["cross4", "ring8"])
def window_ref(request, small_params):
    """The window and JAX's output on it (its jnp path)."""
    params, x = small_params
    ref = JaxPixel(**SMALL, window=request.param).apply(params, jnp.asarray(x))
    return request.param, np.asarray(ref)


@pytest.mark.parametrize("route", list(ROUTES))
def test_pixel_window_routes_match_jax(small_params, window_ref, route):
    """``create_model("multiscale_sequence_denoiser", window=w)`` on each route
    (the kernels' plain versions on the CPU) against JAX's model, atol 1e-3;
    the solve moves the image well beyond that."""
    params, x = small_params
    window, ref = window_ref
    model = create_model("multiscale_sequence_denoiser", **SMALL, window=window,
                         **ROUTES[route])
    params_to_torch(params, model)
    mix = model.mixtureGLR_block03
    assert mix.route() == route and mix.deltas == WINDOWS[window]
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    skip = JaxPixel(**SMALL, eval_skip_solve=True).apply(params, jnp.asarray(x))
    assert np.abs(ref - np.asarray(skip)).max() > 0.05  # what the solve adds


@pytest.mark.parametrize("route", list(ROUTES))
def test_skip_solve_matches_jax_and_calls_no_solver(small_params, route, monkeypatch):
    """``eval_skip_solve`` (JAX's accounting probe: the features, the DC term
    and the combination, no unroll) against JAX's with the same parameters,
    on every route's flags: no solver kernel or plain unroll is called, and
    the model has JAX's skip-solve parameter tree (no graph operators)."""
    params, x = small_params
    ref = np.asarray(JaxPixel(**SMALL, eval_skip_solve=True).apply(params, jnp.asarray(x)))
    for name in SOLVER_KERNELS:
        monkeypatch.setattr(pixel_gtv, name, _refuse(name))
    model = create_model("multiscale_sequence_denoiser", **SMALL, window="ring8",
                         eval_skip_solve=True, **ROUTES[route])
    # JAX's skip-solve model has no graph operators, and nor has the port's
    mix = dict(params["params"]["mixtureGLR_block03"])
    for op in ("GTVmodule00", "GLRmodule00"):
        del mix[op]
    params_to_torch({"params": dict(params["params"], mixtureGLR_block03=mix)}, model)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def _refuse(name):
    def call(*args, **kw):
        raise AssertionError(f"eval_skip_solve called {name}")
    return call


@pytest.mark.parametrize("package", ["jax", "port"])
def test_n_cgd_iters_other_than_4_raises_in_both(package):
    """JAX's MixtureGTV refuses ``n_cgd_iters != 4`` (its unroll is fixed at
    2 ADMM rounds of 2 CG steps), and so does the port, with JAX's reason."""
    if package == "jax":
        x = jnp.zeros((1, 16, 16, 3))
        with pytest.raises(NotImplementedError, match="fixed at 4 CG iterations"):
            JaxMixtureGTV(n_graphs=4, n_node_fts=3, n_cnn_fts=8, n_cgd_iters=3,
                          feature_num_blocks=(1, 1, 1, 1), feature_num_refinement=1
                          ).init(jax.random.PRNGKey(0), x)
    else:
        with pytest.raises(NotImplementedError, match="JAX refuses it too.*fixed at 4"):
            create_model("multiscale_sequence_denoiser", **SMALL, n_cgd_iters=3)
