"""K5's pixel mode and K6a/K6b on the pixel family's window
(``irdu_tpu_torch/ops/fused_step.py``: single scale, diamond-12, the reflect
stencil pad) against the JAX package's Pallas kernels in interpret mode, the
CUDA kernel's padded tile on that window (K5's steps, and the launches K6a
and K6b make of it) run in PyTorch against the plain version and JAX, and
the pixel family's CHW band route (6 K5 steps) against JAX's
``_forward_chw`` with both caps at 0. Tolerances: the JAX tests' 2e-4
(rhs, rethresh, K6a, K6b) and 3e-4 (cg) for the kernels
(tests/test_solver_chw.py), 1e-5 between the port's own f32 formulations,
JAX's kernel-vs-jnp ``atol=5e-4, rtol=1e-3`` for the padded tile and the
route."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_chw import fused_scal as jax_fused_scal
from irdu_tpu.ops.pallas.solver_chw import gg_fused_step_chw as jax_step
from irdu_tpu.ops.pallas.solver_chw import gg_matvec_chw as jax_matvec
from irdu_tpu.ops.pallas.solver_chw import gtv_rethresh_chw as jax_rethresh
from irdu_tpu.ops.windows import EDGE_DELTAS_DIAMOND12
from irdu_tpu.solvers import gtv_glr as jax_gtv_glr
from irdu_tpu.solvers.pixel_gtv import MixtureGTV as JaxMixtureGTV
from irdu_tpu_torch.ops import fused_step as fs
from irdu_tpu_torch.ops.windows import DIAMOND12
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.solvers.pixel_gtv import MixtureGTV
from irdu_tpu_torch.utils.weights import params_to_torch
from test_torch_fused_step import K6_CASES, k6_calls, padded_step, through_kernel

G, F = 2, 3
C = G * F
E = len(DIAMOND12)
H, W = 16, 128
PIXEL = dict(deltas=DIAMOND12, stats_mode="reflect")


def _softmax_weights(rng, h, w):
    z = rng.randn(1, G, E, h, w)
    e = np.exp(z - z.max(axis=2, keepdims=True))
    return (e / e.sum(axis=2, keepdims=True)).astype(np.float32)


def _inputs(seed, h=H, w=W):
    """x, aux, prev (1, C, h, w); the GTV and GLR weights (1, G, 12, h, w);
    two (G, 4, F) tables of scalar coefficients broadcast, as JAX's
    ``_stats_pg`` makes them; the per-graph scalars."""
    rng = np.random.RandomState(seed)
    planes = [(rng.randn(1, C, h, w) * s).astype(np.float32) for s in (1.0, 0.5, 0.5)]
    ws = [_softmax_weights(rng, h, w), _softmax_weights(rng, h, w)]
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)
    tables = [np.broadcast_to((inits + 0.3 * rng.randn(4))[None, :, None], (G, 4, F))
              .astype(np.float32) for _ in range(2)]

    def mk(lo):
        return (rng.rand(G) + lo).astype(np.float32)

    s = dict(mu0=mk(0.1), ro0=mk(0.1), alpha=mk(0.2), beta=mk(0.1), gamma0=mk(0.05) * 0.5)
    return planes, ws, tables, s


def _both(a):
    return (None, None) if a is None else (jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a)))


# the calls of JAX's pixel band route (solvers/pixel_gtv.py:_forward_chw), and
# the no-stats variant: mode, aux, prev, GLR graphs, keywords, scalars, atol
STEP_CASES = {
    "rhs": ("rhs", False, False, False, {}, ("ro0",), 2e-4),
    "cg_use_x_rhs_emit_update": ("cg", False, False, True,
                                 dict(use_x_rhs=True, emit_update=True),
                                 ("mu0", "ro0", "alpha"), 3e-4),
    "cg_prev": ("cg", True, True, True, {}, ("mu0", "ro0", "alpha", "beta"), 3e-4),
    "rethresh_y": ("rethresh", True, False, False, {}, ("ro0", "gamma0"), 2e-4),
    "rhs_no_stats": ("rhs", False, False, False, {}, ("ro0",), 2e-4),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pixel_step_matches_jax_kernel(case):
    mode, has_aux, has_prev, glr, kw, keys, atol = STEP_CASES[case]
    (x, aux, prev), (wg, wl), (pg, pl), s = _inputs(seed=len(case))
    if case.endswith("no_stats"):
        pg = pl = None
    scal = np.array(jax_fused_scal(G, **{k: s[k] for k in keys}))
    args = [x, aux if has_aux else None, prev if has_prev else None, wg,
            wl if glr else None, None, None, pg, pl if glr else None, None, None, scal]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_step(*jargs, mode=mode, n_graphs=G, true_h=H, true_w=W,
                   deltas=EDGE_DELTAS_DIAMOND12, stats_mode="reflect", interpret=True, **kw)
    before = fs.gg_fused_step_chw.launches
    out = fs.gg_fused_step_chw(*targs, mode=mode, n_graphs=G, **PIXEL, **kw)
    assert fs.gg_fused_step_chw.launches == before, "a CPU tensor must not launch"
    refs, outs = (ref, out) if kw.get("emit_update") else ((ref,), (out,))
    for o, r in zip(outs, refs):
        assert o.shape == x.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol)
    assert np.abs(np.asarray(refs[0]) - (aux if mode == "rethresh" else x)).max() > 0.05


@pytest.mark.parametrize("with_glr", [True, False], ids=["glr_identity", "gtv_identity"])
def test_pixel_matvec_matches_jax_kernel(with_glr):
    (x, _, _), (wg, wl), (pg, pl), s = _inputs(seed=10 + with_glr)
    args = [x, wl, wg, pl, pg, s["mu0"], s["ro0"]]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_matvec(*jargs, n_graphs=G, true_h=H, true_w=W, deltas=EDGE_DELTAS_DIAMOND12,
                     stats_mode="reflect", with_glr=with_glr, interpret=True)
    out = fs.gg_matvec_chw(*targs, n_graphs=G, with_glr=with_glr, **PIXEL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("with_y", [True, False], ids=["y", "no_y"])
def test_pixel_rethresh_matches_jax_kernel(with_y):
    (x, y, _), (wg, _), (pg, _), s = _inputs(seed=20 + with_y)
    args = [x, y if with_y else None, wg, pg, s["gamma0"], s["ro0"]]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_rethresh(*jargs, n_graphs=G, true_h=H, true_w=W, deltas=EDGE_DELTAS_DIAMOND12,
                       stats_mode="reflect", interpret=True)
    out = fs.gtv_rethresh_chw(*targs, n_graphs=G, **PIXEL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_identity_table_equals_no_stats():
    """The table (1, 0, 0, 0) the kernel takes for a stencil set to None gives
    the no-stats step exactly, with the reflect pad too."""
    (x, _, _), (wg, wl), _, s = (_inputs(seed=5, h=12, w=20))
    x, wg, wl = (torch.from_numpy(a) for a in (x, wg, wl))
    scal = fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in s.items()})
    eye = fs.identity_table(G, F)
    kw = dict(mode="cg", n_graphs=G, use_x_rhs=True, **PIXEL)
    a = fs.fused_step_plain(x, None, None, wg, wl, None, None, eye, eye, None, None, scal, **kw)
    b = fs.fused_step_plain(x, None, None, wg, wl, None, None, None, None, None, None, scal, **kw)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K5's padded tile (fused_step_hopper.cu) on the diamond-12 window, and the
# single-scale launches of it that K6a and K6b make, transliterated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["rhs", "cg", "rethresh"])
@pytest.mark.parametrize("tile,hw", [(None, (21, 69)), ((32, 64), (35, 27)), (None, (19, 33))],
                         ids=["16x64_odd_ragged", "32x64_odd_one_column", "16x64_odd_two_rows"])
def test_padded_tile_scheme_matches_plain(mode, tile, hw):
    """K5's padded tile (fused_step_hopper.cu) on diamond-12 with the reflect
    pad, on its single-scale 16x64 tile and on 32x64 tiles (the template's
    tile is a parameter), odd H and W: tiles on every image edge, ragged
    last tiles in both directions; the result equals the plain step and no
    cell the kernel leaves uncomputed is read."""
    h, w = hw
    (x, aux, prev), (wg, wl), (pg, pl), s = _inputs(seed=50 + (tile is not None), h=h, w=w)
    x, aux, prev, wg, wl, pg, pl = (torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (x, aux, prev, wg, wl, pg, pl))
    scal = fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in s.items()})
    aux_m = None if mode == "rhs" else aux
    prev_m = prev if mode == "cg" else None
    wl_m = wl if mode == "cg" else None
    out, upd = padded_step(x, aux_m, prev_m, (wg, wl_m, None, None), (pg, pl, None, None),
                           scal, mode, G, tile=tile, deltas=DIAMOND12, reflect=True)
    want = fs.fused_step_plain(x, aux_m, prev_m, wg, wl_m, None, None, pg, pl, None, None,
                               scal, mode=mode, n_graphs=G, emit_update=mode == "cg", **PIXEL)
    if mode == "cg":
        torch.testing.assert_close(upd, want[1], atol=5e-4, rtol=1e-3)
        want = want[0]
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", ["cg_use_x_rhs_emit_update", "rethresh_y"])
def test_padded_tile_scheme_matches_jax_kernel(case):
    """The transliteration against JAX's Pallas kernel in interpret mode at
    the JAX tests' pixel shape (16x128: two columns of its 16x64 tile)."""
    mode, has_aux, has_prev, glr, kw, keys, _ = STEP_CASES[case]
    (x, aux, prev), (wg, wl), (pg, pl), s = _inputs(seed=len(case))
    scal = np.array(jax_fused_scal(G, **{k: s[k] for k in keys}))
    args = [x, aux if has_aux else None, prev if has_prev else None, wg,
            wl if glr else None, None, None, pg, pl if glr else None, None, None, scal]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_step(*jargs, mode=mode, n_graphs=G, true_h=H, true_w=W,
                   deltas=EDGE_DELTAS_DIAMOND12, stats_mode="reflect", interpret=True, **kw)
    out, upd = padded_step(targs[0], targs[1], targs[2], targs[3:7], targs[7:11], targs[11],
                           mode, G, deltas=DIAMOND12, reflect=True,
                           use_x_rhs=bool(kw.get("use_x_rhs")))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[0] if kw else ref),
                               atol=5e-4, rtol=1e-3)
    if kw.get("emit_update"):
        np.testing.assert_allclose(upd.numpy(), np.asarray(ref[1]), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("tile,hw", [(None, (19, 69)), ((32, 64), (35, 27))],
                         ids=["16x64_odd_two_rows", "32x64_odd_one_column"])
def test_k6_padded_tile_matches_plain(case, tile, hw):
    """K6a and K6b on diamond-12 with the reflect pad, the launch each
    wrapper asks for run through K5's single-scale padded tile (16x64) and
    on 32x64 tiles, odd H and W, ragged last tiles: the plain version's
    result, no cell the kernel leaves uncomputed read; and the output moves
    its input."""
    (x, y, _), (wg, wl), (pg, pl), s = _inputs(seed=80 + (tile is not None) + len(case),
                                               h=hw[0], w=hw[1])
    x, y, wg, wl, pg, pl, mu, ro, gamma = (torch.from_numpy(np.ascontiguousarray(a)) for a in (
        x, y, wg, wl, pg, pl, s["mu0"], s["ro0"], s["gamma0"]))
    wrapper, plain = k6_calls(case, x, y, wg, wl, pg, pl, mu, ro, gamma, G, **PIXEL)
    out, want = through_kernel(wrapper, x, G, tile=tile), plain(x)
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)
    base = x if K6_CASES[case][2] else y if K6_CASES[case][3] else 0.0
    assert (want - base).abs().max() > 0.05


@pytest.mark.parametrize("case", ["matvec_glr", "rethresh_y"])
def test_k6_padded_tile_matches_jax_kernel(case):
    """The launches of K6a and K6b through the padded tile on diamond-12
    with the reflect pad against JAX's kernels in interpret mode at the JAX
    tests' pixel shape (16x128: two columns of its 16x64 tile)."""
    kind, with_glr, identity, with_y = K6_CASES[case]
    (x, y, _), (wg, wl), (pg, pl), s = _inputs(seed=90 + len(case))
    jax_pixel = dict(n_graphs=G, true_h=H, true_w=W, deltas=EDGE_DELTAS_DIAMOND12,
                     stats_mode="reflect", interpret=True)
    if kind == "matvec":
        jargs, _ = zip(*(_both(a) for a in (x, wl, wg, pl, pg, s["mu0"], s["ro0"])))
        ref = jax_matvec(*jargs, add_identity=identity, with_glr=with_glr, **jax_pixel)
    else:
        jargs, _ = zip(*(_both(a) for a in (x, y if with_y else None, wg, pg, s["gamma0"],
                                             s["ro0"])))
        ref = jax_rethresh(*jargs, **jax_pixel)
    xt, yt, wgt, wlt, pgt, plt, mu, ro, gamma = (
        torch.from_numpy(np.ascontiguousarray(a))
        for a in (x, y, wg, wl, pg, pl, s["mu0"], s["ro0"], s["gamma0"]))
    wrapper, _ = k6_calls(case, xt, yt, wgt, wlt, pgt, plt, mu, ro, gamma, G, **PIXEL)
    np.testing.assert_allclose(through_kernel(wrapper, xt, G).numpy(), np.asarray(ref),
                               atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the pixel family's CHW band route
# ---------------------------------------------------------------------------

TINY = dict(n_graphs=G, n_node_fts=F, n_cnn_fts=8)


def test_band_route_matches_jax_forward_chw(monkeypatch):
    """Both caps at 0, so JAX's ``_forward_chw`` runs its 6 K5 calls in
    interpret mode and the port its band route (the K5 plain versions, 6
    calls in JAX's order) on a 1x16x128x3 image, with μ, ρ, γ raised."""
    monkeypatch.setattr(jax_gtv_glr, "_MEGA_MAX_PIXELS", 0)
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 0)
    jm = JaxMixtureGTV(**TINY, window="diamond12", feature_num_blocks=(1, 1, 1, 1),
                       feature_num_refinement=1, use_pallas_unroll=True)
    x = np.random.RandomState(2).rand(1, H, W, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(3)
    p = params["params"]
    p["muys00"] = (0.3 + 0.1 * rng.rand(G)).astype(np.float32)
    p["ro00"] = (0.3 + 0.1 * rng.rand(G)).astype(np.float32)
    p["gamma00"] = np.log(0.01 + 0.01 * rng.rand(G)).astype(np.float32)
    assert jm._chw_ok(x.shape) and not jm._mega_ok(x.shape)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = MixtureGTV(**TINY, feature_num_blocks=(1, 1, 1), feature_num_refinement=1,
                       use_pallas_unroll=True)
    params_to_torch(params, model)
    seen = []

    def counted(*args, **kw):
        seen.append((kw["mode"], kw.get("use_x_rhs", False), kw.get("emit_update", False),
                     args[2] is not None, args[1] is not None))
        return fs.gg_fused_step_chw(*args, **kw)

    from irdu_tpu_torch.solvers import pixel_gtv

    monkeypatch.setattr(pixel_gtv, "gg_fused_step_chw", counted)
    before = fs.gg_fused_step_chw.launches
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert fs.gg_fused_step_chw.launches == before
    # (mode, x is its rhs, emits the update, has prev, has aux)
    assert seen == [("rhs", False, False, False, False), ("cg", True, True, False, False),
                    ("cg", False, False, True, True), ("rethresh", False, False, False, True),
                    ("cg", True, True, False, False), ("cg", False, False, True, True)]
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - x).max() > 0.05
