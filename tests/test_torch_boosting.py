"""GLR boosting in the port against the JAX package: the ring-8 window, the
graph ops (``ops/graph.py``: normalize_features, extract_edge_weights,
op_l_norm, per_graph_scale) against JAX's NHWC ones, K2's plain version on
ring-8 against JAX's Pallas kernel in interpret mode and its jnp function,
one pyramid level and the whole pyramid at small widths with JAX-``init``
parameters (jitted; α, β, μ and the metric spread so that every term
shows) carried across by ``params_to_torch``, and the committed snapshot's
layout. Tolerances: ``atol=1e-4, rtol=1e-3`` per op and per level,
``atol=1e-3`` for the whole model (ROADMAP's model bar)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.glr_boosting import GLRBoostingPyramid as JaxPyramid
from irdu_tpu.models.glr_boosting import _LevelGLRSolver as JaxLevel
from irdu_tpu.ops import graph as jax_graph
from irdu_tpu.ops import windows as jax_windows
from irdu_tpu.ops.pallas.solver_chw import edge_weights_chw as jax_edge_weights
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.models.glr_boosting import GLRBoostingPyramid, _LevelGLRSolver
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.windows import RING8, WINDOWS
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, build_model
from irdu_tpu_torch.utils.weights import load_params_npz, params_to_torch

TINY = dict(n_blocks=1, n_levels=3, n_cgd_iters=3, node_fts=(4, 4, 6),
            level_features=(8, 8, 12), muy_init=(0.3, 0.15, 0.075))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


def _feats(b, g, f, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, g * f, h, w).astype(np.float32),
            (0.5 + rng.rand(g, f)).astype(np.float32))


def test_ring8_is_jax_window():
    assert RING8 == jax_windows.EDGE_DELTAS_RING8
    assert {k: WINDOWS[k] for k in jax_windows.WINDOWS} == jax_windows.WINDOWS


@pytest.mark.parametrize("shape", [(1, 5, 4, 16, 24), (2, 3, 6, 8, 13)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ring8_edge_weights_match_jax(shape):
    """K2's plain version (and the wrapper on a CPU tensor) on ring-8 against
    JAX's Pallas kernel in interpret mode (lane-padded features, the true
    width below) and JAX's ``extract_edge_weights`` (NHWC); rows sum to 1."""
    b, g, f, h, w = shape
    feats, m = _feats(*shape)
    wp = -(-w // 128) * 128
    padded = np.pad(feats, ((0, 0), (0, 0), (0, 0), (0, wp - w)))
    kernel = np.asarray(jax_edge_weights(jnp.asarray(padded), jnp.asarray(m), n_graphs=g,
                                         true_h=h, true_w=w, deltas=RING8,
                                         interpret=True))[..., :w]
    jnp_w, _ = jax_graph.extract_edge_weights(jnp.asarray(_nhwc(feats)), jnp.asarray(m),
                                              RING8, g)
    ft, mt = torch.from_numpy(feats), torch.from_numpy(m)
    before = edge_weights_chw.launches
    out = edge_weights_chw(ft, mt, n_graphs=g, deltas=RING8).numpy()
    assert edge_weights_chw.launches == before, "a CPU tensor must not launch"
    assert out.shape == (b, g, 8, h, w)
    np.testing.assert_array_equal(out, edge_weights_plain(ft, mt, g, RING8).numpy())
    np.testing.assert_allclose(out, kernel, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out, np.asarray(jnp_w).transpose(0, 3, 4, 1, 2),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out.sum(axis=2), 1.0, atol=1e-5)


def test_graph_ops_match_jax():
    """normalize_features, extract_edge_weights (in the input dtype),
    op_l_norm on G·c channels and per_graph_scale against JAX's."""
    b, g, f, c, h, w = 2, 3, 4, 5, 8, 11
    feats, m = _feats(b, g, f, h, w, seed=1)
    x = np.random.RandomState(2).randn(b, g * c, h, w).astype(np.float32)
    vec = np.array([0.3, 1.7, 0.9], np.float32)
    ft, mt, xt = (torch.from_numpy(a) for a in (feats, m, x))
    jf, jm, jx = jnp.asarray(_nhwc(feats)), jnp.asarray(m), jnp.asarray(_nhwc(x))

    t = graph.normalize_features(ft, mt, g)
    ref = np.asarray(jax_graph.normalize_features(jf, jm, g))
    np.testing.assert_allclose(_nhwc(t.reshape(b, g * f, h, w)), ref, atol=1e-5, rtol=1e-5)

    wts = graph.extract_edge_weights(ft, mt, g, RING8)
    jw, _ = jax_graph.extract_edge_weights(jf, jm, RING8, g)
    np.testing.assert_allclose(wts.numpy(), np.asarray(jw).transpose(0, 3, 4, 1, 2),
                               atol=1e-5, rtol=1e-4)
    assert graph.extract_edge_weights(ft.double(), mt.double(), g, RING8).dtype == torch.float64

    lx = graph.op_l_norm(xt, wts, g, RING8)
    jl = jax_graph.op_l_norm(jx, jw, RING8, g)
    np.testing.assert_allclose(_nhwc(lx), np.asarray(jl), atol=1e-5, rtol=1e-4)
    s = graph.per_graph_scale(xt, torch.from_numpy(vec))
    np.testing.assert_allclose(_nhwc(s), np.asarray(jax_graph.per_graph_scale(jx, vec)),
                               atol=1e-6)


def _spread(tree, rng):
    """α, β, μ and the metric of every level spread (JAX inits them
    constant): every graph's CG and mixture differ."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "alphaCGD":
                node[k] = (0.3 + 0.4 * rng.rand(*v.shape)).astype(np.float32)
            elif k == "betaCGD":
                node[k] = (0.1 + 0.2 * rng.rand(*v.shape)).astype(np.float32)
            elif k == "muys":
                node[k] = np.log(0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k == "multiM":
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    walk(tree)
    return tree


def _jax_init(module, x, seed=0):
    """JAX's ``init`` (jitted, an "rbg" key: it compiles faster than
    threefry's), spread, as numpy."""
    v = jax.jit(module.init)(jax.random.key(seed, impl="rbg"), jnp.asarray(x))
    return _spread(jax.tree_util.tree_map(np.array, v), np.random.RandomState(seed + 1))


def test_level_solver_matches_jax():
    """One level (c = 6 residual channels, 3 graphs of 4 features, 10-wide
    extractor, 3 CG steps) on a residual, JAX's parameters."""
    kw = dict(n_graphs=3, n_node_fts=4, n_features=10, muy_init=0.2, n_cgd_iters=3)
    r = np.random.RandomState(4).randn(1, 12, 16, 6).astype(np.float32)
    jl = JaxLevel(**kw)
    v = _jax_init(jl, r)
    ref = np.asarray(jax.jit(jl.apply)(v, jnp.asarray(r)))
    level = _LevelGLRSolver(6, **kw)
    params_to_torch(v, level)
    with torch.no_grad():
        out = level(torch.from_numpy(r).permute(0, 3, 1, 2))
        level.use_kernels = False
        plain = level(torch.from_numpy(r).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX pyramid at TINY widths with spread parameters, its output on a
    seeded 16x24 image (one jitted forward), and the port's model with the
    same parameters."""
    x = np.random.RandomState(0).rand(1, 16, 24, 3).astype(np.float32)
    jm = JaxPyramid(**TINY)
    v = _jax_init(jm, x)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    model = registry.create_model("glr_boosting_pyramid", **TINY).eval()
    params_to_torch(v, model)
    return x, ref, model


def test_pyramid_matches_jax(tiny_pair):
    x, ref, model = tiny_pair
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 16, 24, 3)
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert np.abs(out - x).max() > 1e-2  # the model does move its input


def test_pyramid_kernel_switch_and_grad(tiny_pair):
    """``set_kernels(False)`` (the training route) gives the same output on
    the CPU; its gradient reaches every parameter; no K2 launch."""
    x, _, model = tiny_pair
    before = edge_weights_chw.launches
    with torch.no_grad():
        on = model(torch.from_numpy(x))
    registry.set_kernels(model, False)
    try:
        out = model(torch.from_numpy(x))
        out.square().sum().backward()
    finally:
        registry.set_kernels(model, True)
    torch.testing.assert_close(out.detach(), on, atol=0, rtol=0)
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.parameters())
    model.zero_grad(set_to_none=True)
    assert edge_weights_chw.launches == before


def test_pyramid_rejects_sizes_off_the_pyramid(tiny_pair):
    _, _, model = tiny_pair
    with pytest.raises(ValueError, match="multiples of 4"):
        model(torch.zeros(1, 16, 22, 3))


def test_boosting_snapshot_layout():
    """``boosting_synthetic_2050.npz`` onto the default build (predict's
    "boosting"): no leaf without a parameter, no parameter unset; the
    snapshot's scopes include ``level_k/extractor/layers_0``."""
    tree = load_params_npz(DEFAULT_WEIGHTS["boosting"])
    model = build_model("boosting")
    assert isinstance(model, GLRBoostingPyramid)
    params_to_torch(tree, model)
    assert set(tree["params"]["level_0"]["extractor"]) == {"layers_0", "layers_1"}
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(tree))
    torch.testing.assert_close(model.level_3.GLRmodule.multiM,
                               torch.from_numpy(tree["params"]["level_3"]["GLRmodule"]["multiM"]))
