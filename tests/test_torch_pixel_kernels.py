"""The pixel family's kernels in the port against the JAX package: K2 on the
diamond-12 window, K7 (the whole CHW unroll) and K8 (the NHWC segments), each
plain version against the JAX Pallas kernel in interpret mode once at a small
shape; the 6-segment NHWC unroll against JAX's flat-op composition; and the
K8 CUDA kernel's tiling scheme, transliterated, against the plain segment."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.graph import (glr_apply_flat, gtv_apply_flat, op_c_flat,
                                op_c_transpose_flat, soft_threshold)
from irdu_tpu.ops.pallas.pixel_nhwc import RADIUS_W, _halos
from irdu_tpu.ops.pallas.pixel_nhwc import pixel_segment_nhwc as jax_segment
from irdu_tpu.ops.pallas.solver_chw import edge_weights_chw as jax_edge_weights
from irdu_tpu.ops.pallas.solver_unroll import gg_pixel_unroll_chw as jax_pixel_unroll
from irdu_tpu.ops.pallas.solver_unroll import pixel_unroll_scal as jax_pixel_scal
from irdu_tpu.ops import windows as jax_windows
from irdu_tpu.ops.windows import WINDOWS
from irdu_tpu_torch.ops import pixel_nhwc as pn
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.graph import pack_edge_weights
from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw, pixel_unroll_scal
from irdu_tpu_torch.ops.windows import DIAMOND12, window_to_deltas
from irdu_tpu_torch.ops.windows import WINDOWS as PORT_WINDOWS
from test_torch_fused_step import box_at, pad_box, padded_tile_term, zero_box

G, F = 4, 3
C = G * F
E = len(DIAMOND12)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", ["cross4", "diamond12"])
def test_windows_match_jax_edge_order(name):
    assert PORT_WINDOWS[name] == tuple(tuple(d) for d in WINDOWS[name])
    mask = getattr(jax_windows, f"WINDOW_{name.upper()}")
    assert window_to_deltas(mask) == PORT_WINDOWS[name]


# ---------------------------------------------------------------------------
# K2 on the diamond-12 window
# ---------------------------------------------------------------------------

def test_edge_weights_diamond12_match_jax_kernel():
    """2G stacked graphs as the CHW route gives them; the JAX side takes
    128-lane-padded features and the true width."""
    b, g, f, h, w = 1, 2 * G, F, 16, 100
    rng = np.random.RandomState(0)
    feats = rng.randn(b, g * f, h, w).astype(np.float32)
    multi_m = (1.0 + 0.3 * rng.randn(g, f)).astype(np.float32)
    padded = np.pad(feats, ((0, 0), (0, 0), (0, 0), (0, 128 - w)))
    ref = np.asarray(jax_edge_weights(jnp.asarray(padded), jnp.asarray(multi_m), n_graphs=g,
                                      true_h=h, true_w=w, deltas=DIAMOND12,
                                      interpret=True))[..., :w]
    before = edge_weights_chw.launches
    out = edge_weights_chw(_t(feats), _t(multi_m), n_graphs=g, deltas=DIAMOND12).numpy()
    assert edge_weights_chw.launches == before, "a CPU tensor must not launch"
    assert out.shape == (b, g, E, h, w)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out.sum(axis=2), 1.0, atol=1e-5)


def test_packed_weights_are_k2_weights_channels_last():
    rng = np.random.RandomState(1)
    feats, m = _t(rng.randn(2, C, 8, 12).astype(np.float32)), _t(rng.rand(G, F) + 0.5)
    w = edge_weights_chw(feats, m.float(), n_graphs=G, deltas=DIAMOND12)
    packed = pack_edge_weights(w)
    assert packed.shape == (2, 8, 12, E * G)
    for e in (0, 5, 11):
        for g in (0, G - 1):
            torch.testing.assert_close(packed[..., e * G + g], w[:, g, e], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K7: the whole CHW unroll
# ---------------------------------------------------------------------------

def _softmax_weights(rng, h, w):
    z = rng.randn(1, G, E, h, w)
    ex = np.exp(z - z.max(axis=2, keepdims=True))
    return (ex / ex.sum(axis=2, keepdims=True)).astype(np.float32)


def _unroll_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    y = rng.rand(1, F, h, w).astype(np.float32)
    wg, wl = _softmax_weights(rng, h, w), _softmax_weights(rng, h, w)
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    pg, pl = ((inits + 0.3 * rng.randn(G, 4, F)).astype(np.float32) for _ in range(2))
    mu, ro = (0.2 + 0.1 * rng.rand(G)).astype(np.float32), (0.2 + 0.1 * rng.rand(G)).astype(np.float32)
    gamma = (0.02 + 0.01 * rng.rand(G)).astype(np.float32)
    alphas = (0.5 + 0.1 * rng.randn(4, G)).astype(np.float32)
    betas = (0.1 + 0.05 * rng.randn(4, G)).astype(np.float32)
    return y, wg, wl, pg, pl, (mu, ro, gamma, alphas, betas)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "no_stats"])
def test_pixel_unroll_matches_jax_kernel(stats):
    y, wg, wl, pg, pl, coef = _unroll_inputs(16, 128, seed=3 + stats)
    scal = np.asarray(jax_pixel_scal(G, *coef))
    tabs = (pg, pl) if stats else (None, None)
    ref = np.asarray(jax_pixel_unroll(_j(y), _j(wg), _j(wl), *map(_j, tabs), _j(scal),
                                      n_graphs=G, deltas=DIAMOND12, interpret=True))
    before = gg_pixel_unroll_chw.launches
    out = gg_pixel_unroll_chw(_t(y), _t(wg), _t(wl), *map(_t, tabs), _t(scal),
                              n_graphs=G).numpy()
    assert gg_pixel_unroll_chw.launches == before, "a CPU tensor must not launch"
    assert out.shape == (1, C, 16, 128)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    # the solve moves the tiled ỹ well beyond the tolerance
    assert np.abs(ref - np.tile(y, (1, G, 1, 1))).max() > 0.05


def test_pixel_unroll_scal_matches_jax_layout():
    *_, coef = _unroll_inputs(8, 8, seed=1)
    ours = pixel_unroll_scal(G, *map(_t, coef))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_pixel_scal(G, *coef)))


@pytest.mark.parametrize("bad", ["weights", "scal", "one_table"])
def test_pixel_unroll_rejects_bad_arguments(bad):
    y, wg, wl, pg, pl, coef = (_t(a) if not isinstance(a, tuple) else a
                               for a in _unroll_inputs(8, 8, seed=2))
    scal = pixel_unroll_scal(G, *map(_t, coef))
    if bad == "weights":
        wg = wg[:, :, :4]
    elif bad == "scal":
        scal = scal[:, :8]
    else:
        pl = None
    with pytest.raises(ValueError):
        gg_pixel_unroll_chw(y, wg, wl, pg, pl, scal, n_graphs=G)


# ---------------------------------------------------------------------------
# K8: the NHWC segments
# ---------------------------------------------------------------------------

def _nhwc_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    x, aux = (rng.rand(1, h, w, C).astype(np.float32) for _ in range(2))
    prev = (0.3 * rng.randn(1, h, w, C)).astype(np.float32)
    wg, wl = (rng.dirichlet(np.ones(E), size=(1, h, w, G)).astype(np.float32)
              .transpose(0, 1, 2, 4, 3).reshape(1, h, w, E * G).copy() for _ in range(2))
    p = (np.array([[1.0, 0.5, 0.5, 0.5]]) + 0.2 * rng.randn(2, 4)).astype(np.float32)
    scal = {"mu": 0.2 + 0.1 * rng.rand(G), "ro": 0.2 + 0.1 * rng.rand(G),
            "gamma": 0.02 + 0.01 * rng.rand(G), "alpha": 0.5 + 0.1 * rng.randn(4, G),
            "beta": 0.1 + 0.05 * rng.randn(4, G)}
    planar = {k: np.tile(v, (1, F) if v.ndim == 2 else F).astype(np.float32)
              for k, v in scal.items()}
    return x, aux, prev, wg, wl, p, planar


def _rows(planar, i, with_beta=True):
    return np.stack([planar["mu"], planar["ro"], planar["gamma"], planar["alpha"][i],
                     planar["beta"][i] if with_beta else 0 * planar["mu"]]).astype(np.float32)


SEGMENTS = {"rhs": (False, False, False), "cg1": (False, False, True),
            "cg2": (True, True, True), "rethresh": (True, False, False)}  # aux, prev, w_glr


@pytest.mark.parametrize("mode", list(SEGMENTS))
def test_pixel_segment_matches_jax_kernel(mode):
    x, aux, prev, wg, wl, p, planar = _nhwc_inputs(16, 128, seed=7)
    use_aux, use_prev, use_glr = SEGMENTS[mode]
    args = (x, aux if use_aux else None, prev if use_prev else None, wg,
            wl if use_glr else None, p, _rows(planar, 1))
    halos = (_halos(_j(wg), 16, RADIUS_W), _halos(_j(wl), 16, RADIUS_W))
    ref = jax_segment(*map(_j, args[:5]), halos, *map(_j, args[5:]), mode=mode, tile_h=16,
                      n_graphs=G, deltas=DIAMOND12, interpret=True)
    before = pn.pixel_segment_nhwc.launches
    out = pn.pixel_segment_nhwc(*map(_t, args), mode=mode, n_graphs=G)
    assert pn.pixel_segment_nhwc.launches == before, "a CPU tensor must not launch"
    outs, refs = (out, ref) if mode == "cg1" else ((out,), (ref,))
    for o, r in zip(outs, refs):
        assert o.shape == x.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=5e-5, rtol=1e-4)
    base = aux if mode == "rethresh" else x
    assert np.abs(np.asarray(refs[0]) - base).max() > 0.05


@pytest.mark.parametrize("what", ["mode", "missing_aux", "weights", "p"])
def test_pixel_segment_rejects_bad_arguments(what):
    x, aux, prev, wg, wl, p, planar = map(
        lambda a: a if isinstance(a, dict) else _t(a), _nhwc_inputs(8, 8, seed=1))
    kw = dict(mode="cg2", n_graphs=G)
    args = [x, aux, prev, wg, wl, p, _t(_rows(planar, 1))]
    if what == "mode":
        kw["mode"] = "cg3"
    elif what == "missing_aux":
        args[1] = None
    elif what == "weights":
        args[3] = wg[..., :-1]
    else:
        args[5] = p[:1]
    with pytest.raises(ValueError):
        pn.pixel_segment_nhwc(*args, **kw)


def _flat_reference(y72, wg_packed, wl_packed, p, planar):
    """The MixtureGTV unroll (irdu_tpu/solvers/pixel_gtv.py __call__) in the
    planar layout through JAX's flat ops, as tests/test_pixel_nhwc.py builds it."""
    b, h, w, _ = y72.shape

    def flat(packed):  # (B, H, W, E·G) → E × (B, H, W, C) planar (tiled over F)
        wv = jnp.asarray(packed).reshape(b, h, w, E, G)
        return tuple(jnp.tile(wv[..., e, :], (1, 1, 1, F)) for e in range(E))

    wg, wl = flat(wg_packed), flat(wl_packed)

    def stats(row):
        return {k: jnp.asarray(p[row, i:i + 1]) for i, k in enumerate(("p01", "p02a", "p02b",
                                                                         "p03"))}

    sg, sl = stats(0), stats(1)
    mu, ro, gamma = (jnp.asarray(planar[k]) for k in ("mu", "ro", "gamma"))
    a, bt = jnp.asarray(planar["alpha"]), jnp.asarray(planar["beta"])
    y = jnp.asarray(y72)

    def matvec(x):
        return (x + mu * glr_apply_flat(x, wl, DIAMOND12, sl, "reflect")
                + ro * gtv_apply_flat(x, wg, DIAMOND12, sg, "reflect"))

    def rhs_of(eps_minus_bias):
        return ro * op_c_transpose_flat(eps_minus_bias, wg, DIAMOND12, sg) + y

    def cg_round(rhs, a0, b1, a1):
        upd = rhs - matvec(rhs)
        out = rhs + a0 * upd
        upd = rhs - matvec(out) + b1 * upd
        return out + a1 * upd

    rhs = rhs_of(op_c_flat(y, wg, DIAMOND12, sg, "reflect"))
    out = cg_round(rhs, a[0], bt[1], a[1])
    cx = op_c_flat(out, wg, DIAMOND12, sg, "reflect")
    eps = tuple(soft_threshold(c, gamma) for c in cx)
    rhs = rhs_of(tuple(e - (c - e) for e, c in zip(eps, cx)))
    return np.asarray(cg_round(rhs, a[2], bt[3], a[3]))


def test_pixel_unroll_nhwc_matches_flat_ops():
    y72, _, _, wg, wl, p, planar = _nhwc_inputs(24, 40, seed=11)
    ref = _flat_reference(y72, wg, wl, p, planar)
    out = pn.pixel_unroll_nhwc(_t(y72), _t(wg), _t(wl), _t(p),
                               {k: _t(v) for k, v in planar.items()}, n_graphs=G)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-4)
    assert np.abs(ref - y72).max() > 0.05


# ---------------------------------------------------------------------------
# the K8 CUDA kernel's scheme (kernels/csrc/pixel_nhwc.cu), transliterated:
# per output tile and group of graphs (the last group partial where the
# group size does not divide G), the group's weight boxes once (zero outside
# the image), then each feature f's x box of the group's lanes (the reflect
# pad) through the padded tile of tests/test_torch_fused_step.py: stage
# planes over boxes not clipped to the image, read by unclamped offsets
# ---------------------------------------------------------------------------


def _tiled_segment(x, aux, prev, wg, wl, p, scal, mode, th=16, tw=32, lanes=2, n_graphs=G):
    """K8 as the kernel computes it, f32, batch 1: the tiles in launch order
    (row-major), each tile's groups of ``lanes`` graphs, each group walking
    the F features; returns out, or (out, upd) for cg1."""
    _, h, w, c = x.shape
    f_n, n_e, hx = c // n_graphs, len(DIAMOND12), pn.K8_HALO
    geo = dict(th=th, tw=tw, hs=hx - 1, hsc=hx - 1)
    glr = mode in ("cg1", "cg2")

    def per_graph(packed):  # (1, H, W, E·G) → (G, E, H, W)
        return packed[0].reshape(h, w, n_e, n_graphs).permute(3, 2, 0, 1)

    wgv = per_graph(wg)
    wlv = per_graph(wl) if glr else None
    xc = x[0].permute(2, 0, 1)  # (C, H, W)
    mu, ro, gamma, alpha, beta = scal
    out, upd = torch.full_like(x, float("nan")), torch.full_like(x, float("nan"))
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            i1, j1 = min(i0 + th, h), min(j0 + tw, w)
            for g0 in range(0, n_graphs, lanes):
                gs = list(range(g0, min(g0 + lanes, n_graphs)))
                wgb = zero_box(wgv[gs], i0 - geo["hs"], j0 - geo["hs"], th + 2 * geo["hs"],
                               tw + 2 * geo["hs"])
                wlb = (zero_box(wlv[gs], i0 - geo["hs"], j0 - geo["hs"], th + 2 * geo["hs"],
                                tw + 2 * geo["hs"]) if glr else None)
                for f in range(f_n):
                    chs = [f * n_graphs + g for g in gs]
                    xb = pad_box(xc[chs], i0 - hx, j0 - hx, th + 2 * hx, tw + 2 * hx, True)

                    def taps(di, dj, rows, cols, xb=xb):
                        ci = (i0 - geo["hs"] + rows).clamp(0, h - 1) - (i0 - hx)
                        cj = (j0 - geo["hs"] + cols).clamp(0, w - 1) - (j0 - hx)
                        return box_at(xb, ci + di, cj + dj)

                    lp = [p[k].expand(len(gs), 4) for k in range(2)]
                    t = padded_tile_term(geo, taps, wgb, wlb, lp[0], lp[1], ro[chs], mu[chs],
                                         gamma[chs] if mode == "rethresh" else None, i0, j0,
                                         h, w, DIAMOND12)
                    t = t[:, :i1 - i0, :j1 - j0].permute(1, 2, 0)
                    xv = xb[:, hx:hx + i1 - i0, hx:hx + j1 - j0].permute(1, 2, 0)
                    sl = (0, slice(i0, i1), slice(j0, j1), chs)
                    if mode == "rhs":
                        out[sl] = xv + t
                    elif mode == "rethresh":
                        out[sl] = aux[sl] + t
                    else:
                        u = -t if mode == "cg1" else aux[sl] - xv - t + beta[chs] * prev[sl]
                        upd[sl], out[sl] = u, xv + alpha[chs] * u
    return (out, upd) if mode == "cg1" else out


@pytest.mark.parametrize("mode", list(SEGMENTS))
@pytest.mark.parametrize("th,tw,lanes", [pn.K8_PLANS[pn.K8_PLAN][:3], (6, 10, 2)],
                         ids=["kernel_tile", "small_odd_tiles"])
def test_kernel_tiling_scheme_matches_plain(mode, th, tw, lanes):
    """20x36 image: tiles on every edge, interior tiles, ragged last tiles
    in both directions (the served plan's 16x32 tile of 4 graphs, and 6x10
    of 2); the result equals the plain segment and no cell the kernel
    leaves uncomputed is read."""
    x, aux, prev, wg, wl, p, planar = map(
        lambda a: a if isinstance(a, dict) else _t(a), _nhwc_inputs(20, 36, seed=21))
    use_aux, use_prev, use_glr = SEGMENTS[mode]
    scal = _t(_rows(planar, 1))
    args = (x, aux if use_aux else None, prev if use_prev else None, wg,
            wl if use_glr else None, p, scal)
    got = _tiled_segment(*args, mode, th, tw, lanes)
    want = pn.pixel_segment_plain(*args, mode=mode, n_graphs=G)
    for g_, w_ in zip(*((got, want) if mode == "cg1" else ((got,), (want,)))):
        torch.testing.assert_close(g_, w_, atol=1e-5, rtol=1e-5)


def test_tiled_unroll_matches_flat_ops_over_several_tiles():
    """The 6-segment unroll through the kernel's scheme: 20 rows and 36
    columns are two tile rows and two tile columns of the served 16x32
    tile, the last of each ragged."""
    y72, _, _, wg, wl, p, planar = _nhwc_inputs(20, 36, seed=5)
    ref = _flat_reference(y72, wg, wl, p, planar)
    real = pn.pixel_segment_nhwc
    try:
        pn.pixel_segment_nhwc = (lambda x, aux, prev, w_gtv, w_glr, p_, sc, *, mode, n_graphs,
                                 deltas: _tiled_segment(x, aux, prev, w_gtv, w_glr, p_, sc,
                                                        mode))
        out = pn.pixel_unroll_nhwc(_t(y72), _t(wg), _t(wl), _t(p),
                                   {k: _t(v) for k, v in planar.items()}, n_graphs=G)
    finally:
        pn.pixel_segment_nhwc = real
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-4)


def _grouped_inputs(h, w, n_graphs, seed):
    """_nhwc_inputs with n_graphs graphs: x, aux, prev, packed weights, p
    and one step's (5, C) rows."""
    rng = np.random.RandomState(seed)
    c = F * n_graphs
    x, aux = (_t(rng.rand(1, h, w, c).astype(np.float32)) for _ in range(2))
    prev = _t((0.3 * rng.randn(1, h, w, c)).astype(np.float32))
    wg, wl = (_t(rng.dirichlet(np.ones(E), size=(1, h, w, n_graphs)).astype(np.float32)
                 .transpose(0, 1, 2, 4, 3).reshape(1, h, w, E * n_graphs).copy())
              for _ in range(2))
    p = _t((np.array([[1.0, 0.5, 0.5, 0.5]]) + 0.2 * rng.randn(2, 4)).astype(np.float32))
    rows = np.stack([0.2 + 0.1 * rng.rand(c), 0.2 + 0.1 * rng.rand(c), 0.02 + 0.01 * rng.rand(c),
                     0.5 + 0.1 * rng.randn(c), 0.1 + 0.05 * rng.randn(c)])
    return x, aux, prev, wg, wl, p, _t(rows.astype(np.float32))


@pytest.mark.parametrize("mode", list(SEGMENTS))
@pytest.mark.parametrize("tile,n_graphs,hw,seed", [
    ((16, 32, 4), 2, (19, 37), 61), ((32, 32, 2), 3, (33, 35), 62),
    ((16, 32, 4), 8, (17, 18), 61), ((16, 32, 2), 5, (23, 31), 60)],
    ids=["16x32_4graphs_G2_partial_group", "32x32_2graphs_G3_partial_group",
         "16x32_4graphs_G8", "16x32_2graphs_G5"])
def test_grouped_tiles_match_plain(mode, tile, n_graphs, hw, seed):
    """K8's tiling (pixel_nhwc.cu: a tile and the graphs a CTA takes; its
    two plans, K8_PLANS, and a 32x32 tile of 2 graphs, which the template
    takes too) over odd H and W, a group size that does not divide G (the
    last group partial) and G = 2 with groups of 4: the transliteration
    equals the plain segment."""
    th, tw, lanes = tile
    x, aux, prev, wg, wl, p, scal = _grouped_inputs(*hw, n_graphs, seed=seed)
    use_aux, use_prev, use_glr = SEGMENTS[mode]
    args = (x, aux if use_aux else None, prev if use_prev else None, wg,
            wl if use_glr else None, p, scal)
    got = _tiled_segment(*args, mode, th, tw, lanes, n_graphs)
    want = pn.pixel_segment_plain(*args, mode=mode, n_graphs=n_graphs)
    for g_, w_ in zip(*((got, want) if mode == "cg1" else ((got,), (want,)))):
        torch.testing.assert_close(g_, w_, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", ["cg2", "rethresh"])
def test_grouped_tiles_match_jax_kernel(mode):
    """The transliteration with the served plan against JAX's Pallas kernel
    in interpret mode at the JAX tests' shape (16x128: four tile columns of
    the served 16x32 tile, one group of 4 graphs)."""
    x, aux, prev, wg, wl, p, planar = _nhwc_inputs(16, 128, seed=7)
    use_aux, use_prev, use_glr = SEGMENTS[mode]
    args = (x, aux if use_aux else None, prev if use_prev else None, wg,
            wl if use_glr else None, p, _rows(planar, 1))
    halos = (_halos(_j(wg), 16, RADIUS_W), _halos(_j(wl), 16, RADIUS_W))
    ref = jax_segment(*map(_j, args[:5]), halos, *map(_j, args[5:]), mode=mode, tile_h=16,
                      n_graphs=G, deltas=DIAMOND12, interpret=True)
    th, tw, lanes, _ = pn.K8_PLANS[pn.K8_PLAN]
    got = _tiled_segment(*map(_t, args), mode, th, tw, lanes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4, rtol=1e-3)


def test_k8_smem_bytes_fit_the_card():
    """Every built K8 plan fits a CTA (227 KB): each in bf16, plan 0 (f32's)
    in f32 too."""
    for plan in range(len(pn.K8_PLANS)):
        for esize in ((2, 4) if plan == 0 else (2,)):
            assert pn.k8_smem_bytes(True, plan, esize) <= 232448
