"""K1 (the whole solver unroll) of the port against the JAX package's Pallas
kernel in interpret mode, at the shape classes of tests/test_solver_unroll.py;
the CUDA kernel's scheme (its five phases through the tile step, f32 between
them) transliterated into PyTorch against both; the port's MixtureGTVGLR
against the JAX jnp solver path; and the solver's routing: K1 for planes
under the cap, the K5 band route (against JAX's band route and against the
port's own K1 route) for the rest."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_unroll import gg_unroll_chw as jax_unroll
from irdu_tpu.ops.pallas.solver_unroll import unroll_scal as jax_unroll_scal
from irdu_tpu.solvers import gtv_glr as jax_gtv_glr
from irdu_tpu.solvers.gtv_glr import MixtureGTVGLR as JaxMixture
from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain, unroll_scal
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR
from irdu_tpu_torch.utils.weights import params_to_torch
from test_torch_fused_step import tiled_step

G, F = 2, 3
C = G * F


def _softmax_weights(rng, h, w):
    z = rng.randn(1, G, 4, h, w)
    e = np.exp(z - z.max(axis=2, keepdims=True))
    return (e / e.sum(axis=2, keepdims=True)).astype(np.float32)


def _unroll_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    y = (0.3 * rng.randn(1, C, h, w)).astype(np.float32)
    ws = [_softmax_weights(rng, h, w), _softmax_weights(rng, h, w),
          _softmax_weights(rng, h // 2, w // 2), _softmax_weights(rng, h // 2, w // 2)]
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    tables = [(inits + 0.3 * rng.randn(G, 4, F)).astype(np.float32) for _ in range(4)]
    # μ, ρ, γ well above the snapshot's tiny inits so every term shows
    logs = [np.log(v) + 0.3 * rng.randn(G) for v in (0.05, 0.1, 0.02, 0.05, 0.05, 0.05)]
    alphas = (0.5 + 0.1 * rng.randn(3, G)).astype(np.float32)
    betas = (0.1 + 0.05 * rng.randn(3, G)).astype(np.float32)
    scal = np.array(jax_unroll_scal(G, *[np.exp(v) for v in logs], alphas, betas))
    return y, ws, tables, scal, (logs, alphas, betas)


def _lane_pad(a, width):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _jax_unroll(y, ws, tables, scal, iters, **opts):
    """JAX's K1 in interpret mode on 128-lane-padded planes, cropped; tables
    may be None; ``opts``: its ``deltas`` and ``stats_mode``."""
    w = y.shape[-1]
    wp, w1p = max(w, 128), max(w // 2, 128)
    return np.asarray(jax_unroll(
        jnp.asarray(_lane_pad(y, wp)),
        *[jnp.asarray(_lane_pad(a, wp)) for a in ws[:2]],
        *[jnp.asarray(_lane_pad(a, w1p)) for a in ws[2:]],
        *[None if t is None else jnp.asarray(t) for t in tables], jnp.asarray(scal),
        n_graphs=G, eval_cg_iters=iters, true_w=w if wp != w else None,
        interpret=True, **opts))[..., :w]


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("h,w", [(16, 256), (32, 128), (32, 64)],
                         ids=["16x256", "32x128_halfres_padded", "32x64_fullres_padded"])
def test_unroll_matches_jax_kernel(h, w, iters):
    y, ws, tables, scal, _ = _unroll_inputs(h, w, seed=h + w + iters)
    ref = _jax_unroll(y, ws, tables, scal, iters)
    before = gg_unroll_chw.launches
    out = gg_unroll_chw(*[torch.from_numpy(a) for a in (y, *ws, *tables, scal)],
                        n_graphs=G, eval_cg_iters=iters).numpy()
    assert gg_unroll_chw.launches == before, "a CPU tensor must not launch"
    assert out.shape == y.shape
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


def _k1_scheme(y, ws, tables, scal, iters, th, tw, **opts):
    """The CUDA kernel's phases (kernels/csrc/gg_unroll.cu), each through the
    tile step on th x tw tiles, with x, rhs_b and u carried in f32: rhs_a;
    CG step 1 from x = rhs_a; the re-threshold to rhs_b; CG step 2 emitting
    u1; CG step 3 on x1 + a1 u1, formed as it is read. ``opts``: the tile
    step's window and pad (``deltas``, ``pad``)."""
    mu0, ro0, mu1, ro1, gam0, gam1, a0, a1, a2, b2 = scal.unbind(1)
    zero = torch.zeros_like(mu0)

    def coefs(alpha=zero, x_coef=zero):  # the tile step's (G, 9) order
        return torch.stack([mu0, ro0, mu1, ro1, alpha, b2, gam0, gam1, x_coef], 1)

    def step(x, aux, prev, mode, c, **kw):
        return tiled_step(x, aux, prev, ws, tables, c, mode, th, tw, G, **kw, **opts)

    rhs_a, _ = step(y, None, None, "rhs", coefs())
    x1, _ = step(rhs_a, None, None, "cg", coefs(a0), use_x_rhs=True)
    if iters == 1:
        return x1
    rhs_b, _ = step(x1, y, None, "rethresh", coefs())
    x2, u1 = step(x1, rhs_b, None, "cg", coefs(a1))
    if iters == 2:
        return x2
    return step(x1, rhs_b, u1, "cg", coefs(a2, x_coef=a1), x_add=u1)[0]


@functools.lru_cache(maxsize=None)
def _scheme_case(h, w, iters):
    """Seeded inputs at h x w and JAX's K1 output on them."""
    y, ws, tables, scal, _ = _unroll_inputs(h, w, seed=3 * h + w)
    return (y, ws, tables, scal), _jax_unroll(y, ws, tables, scal, iters)


@pytest.mark.parametrize("th,tw", [(8, 16), (5, 7)], ids=["8x16", "5x7_ragged"])
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("h,w", [(32, 64), (24, 36)], ids=["32x64", "24x36_ragged"])
def test_kernel_phase_scheme_matches_plain_and_jax(h, w, iters, th, tw):
    """Tiles on every image edge, interior tiles, ragged last tiles and (5x7)
    half tiles of odd size: the scheme equals the plain unroll and JAX's K1."""
    (y, ws, tables, scal), ref = _scheme_case(h, w, iters)
    args = [torch.from_numpy(a) for a in (y, *ws, *tables, scal)]
    out = _k1_scheme(args[0], args[1:5], args[5:9], args[9], iters, th, tw)
    plain = gg_unroll_plain(*args, n_graphs=G, eval_cg_iters=iters)
    assert np.abs(ref - y).max() > 0.05  # the solve moved its input
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_unroll_scal_matches_jax_layout():
    _, _, _, scal, (logs, alphas, betas) = _unroll_inputs(16, 32, seed=1)
    ours = unroll_scal(G, *[torch.tensor(np.exp(v)) for v in logs],
                       torch.tensor(alphas), torch.tensor(betas))
    np.testing.assert_allclose(ours.numpy(), scal, rtol=1e-6)


@pytest.mark.parametrize("iters", [1, 3])
def test_mixture_gtv_glr_matches_jax_jnp_path(iters):
    """The port's solver module (feature heads, K2 with GTV and GLR batched
    as 2G graphs, K1) against the JAX jnp path, randomized params."""
    rng = np.random.RandomState(iters)
    x = (0.3 * rng.randn(1, 16, 32, C)).astype(np.float32)
    jm = JaxMixture(n_graphs=G, n_node_fts=F, eval_cg_iters=iters)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
        params)
    # μ, ρ, γ well above their tiny inits so the solver terms show
    for name in ("ro00", "ro01", "gamma00", "gamma01", "muys00", "muys01"):
        params["params"][name] = params["params"][name] + np.log(50.0).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = MixtureGTVGLR(G, F, eval_cg_iters=iters)
    params_to_torch(params, tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("bad", ["reflect", "no_stats", "iters", "odd", "weights"])
def test_unroll_rejects_what_it_does_not_port(bad):
    """Refused: eval_cg_iters outside 1-3, an odd H, weights of the wrong
    shape. The reflect stencil pad and tables set to None (once refused) are
    ported: they agree with JAX's K1 with the same options."""
    y, ws, tables, scal, _ = (_unroll_inputs(16, 32, seed=2))
    args = [torch.from_numpy(a) for a in (y, *ws, *tables, scal)]
    kw = dict(n_graphs=G)
    err = ValueError
    if bad in ("reflect", "no_stats"):
        opts = {"stats_mode": "reflect"} if bad == "reflect" else {}
        if bad == "no_stats":
            tables, args[5:9] = [None] * 4, [None] * 4
        ref = _jax_unroll(y, ws, tables, scal, 3, **opts)
        out = gg_unroll_chw(*args, **kw, **opts).numpy()
        assert np.abs(ref - y).max() > 0.05  # the solve moved its input
        np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
        return
    if bad == "iters":
        kw["eval_cg_iters"] = 4
    elif bad == "odd":
        args[0] = args[0][..., :15, :]
    else:
        args[3] = args[3][..., :-1]
    with pytest.raises(err):
        gg_unroll_chw(*args, **kw)


# ---------------------------------------------------------------------------
# routing: K1 for planes under the cap, the K5 band route for the rest
# ---------------------------------------------------------------------------

FLAGSHIP_SCALES = ((48, 8), (96, 16), (192, 16), (384, 32))  # (C, G) per scale
# the port's route per scale at each request: K1 under the cap, K5 above
ROUTES = {(512, 512): "K1 K1 K1 K1", (480, 320): "K1 K1 K1 K1",
          (256, 384): "K1 K1 K1 K1", (1024, 1024): "K5 K1 K1 K1",
          (2048, 2048): "K5 K5 K1 K1"}
# where JAX runs its jnp path (H % 16, (H/2) % 8 or, above the cap, W % 256)
JAX_JNP = {(480, 320): (2, 3)}


@pytest.mark.parametrize("hw", list(ROUTES), ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_route_agrees_with_jax(hw):
    """The port's K1/K5 choice per flagship scale against JAX's
    ``_chw_ok``/``_mega_ok``; where JAX runs its jnp path, the port's
    documented kernel route."""
    h, w = hw
    for s, (c, g) in enumerate(FLAGSHIP_SCALES):
        shape = (1, h >> s, w >> s, c)
        jm = JaxMixture(n_graphs=g, n_node_fts=c // g)
        jax_route = ("jnp" if not jm._chw_ok(shape)
                     else "K1" if JaxMixture._mega_ok(shape) else "K5")
        port = "K1" if gtv_glr._mega_ok((1, c, h >> s, w >> s)) else "K5"
        assert port == ROUTES[hw].split()[s], (hw, s)
        if s in JAX_JNP.get(hw, ()):
            assert jax_route == "jnp", (hw, s)
        else:
            assert jax_route == port, (hw, s)


@pytest.mark.parametrize("hw,want", [((16, 256), True), ((768, 1024), True),
                                     ((769, 1024), False), ((1024, 1024), False),
                                     ((16, 1026), False), ((30, 20), True), ((16, 15), False)],
                         ids=lambda v: str(v))
def test_mega_ok_rule(hw, want):
    """H·Wp ≤ 768·1024 with Wp = W rounded up to 128, both extents ≤ 1024,
    W even; no H % 16 rule (JAX's TPU tiling rule)."""
    assert gtv_glr._mega_ok((1, 6) + hw) is want


def _randomized_pair(h, w, iters, seed):
    """JAX's MixtureGTVGLR params randomized as tests/test_solver_unroll.py
    does, μ/ρ/γ raised ×50 so the solver terms show; the port's module with
    the same params."""
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(1, h, w, C)).astype(np.float32)
    jm = JaxMixture(n_graphs=G, n_node_fts=F, eval_cg_iters=iters)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    for name in ("ro00", "ro01", "gamma00", "gamma01", "muys00", "muys01"):
        params["params"][name] = params["params"][name] + np.log(50.0).astype(np.float32)
    tm = MixtureGTVGLR(G, F, eval_cg_iters=iters)
    params_to_torch(params, tm)
    return x, params, tm


def _port(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_band_route_matches_jax_band_route(monkeypatch, iters):
    """Both caps at 0: the port's K5 steps (their plain versions) against
    JAX's band kernels in interpret mode, 16x256 (tests/test_solver_unroll.py
    ::test_band_path_still_matches)."""
    monkeypatch.setattr(jax_gtv_glr, "_MEGA_MAX_PIXELS", 0)
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 0)
    x, params, tm = _randomized_pair(16, 256, iters, seed=9 + iters)
    fast = JaxMixture(n_graphs=G, n_node_fts=F, eval_cg_iters=iters, use_pallas_unroll=True)
    assert fast._chw_ok(x.shape) and not fast._mega_ok(x.shape)
    ref = np.asarray(fast.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(_port(tm, x), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("iters,calls", [(1, 2), (2, 4), (3, 5)])
def test_band_route_matches_k1_route(monkeypatch, iters, calls):
    """The same module on the same input through K1 and through the K5 steps
    (plain versions, f32): equal within the kernels' bar; the band route
    makes 2, 4 or 5 step calls."""
    x, _, tm = _randomized_pair(16, 256, iters, seed=20 + iters)
    seen = []

    def counted(*args, **kw):
        seen.append(kw["mode"])
        return gg_fused_step_chw(*args, **kw)

    monkeypatch.setattr(gtv_glr, "gg_fused_step_chw", counted)
    via_k1 = _port(tm, x)
    assert not seen
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 0)
    via_k5 = _port(tm, x)
    assert seen == ["rhs", "cg", "rethresh", "cg", "cg"][:calls]
    assert np.abs(via_k1 - x).max() > 0.05  # the solver moved its input
    np.testing.assert_allclose(via_k5, via_k1, atol=5e-4, rtol=1e-3)
