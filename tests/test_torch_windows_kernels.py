"""K7 and K8's four modes on the pixel family's other windows, cross-4 and
ring-8 (K5 on its new windows: tests/test_torch_windows_step.py). Each
plain version against JAX's Pallas kernel in interpret mode (``atol=5e-4,
rtol=1e-3``, tests/test_solver_unroll.py:39-40), and each CUDA kernel's
tile scheme, transliterated, against the plain version; the planners'
shared memory per window (K5's too); the window codes; the launch route's
window rule."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops import windows as jax_windows
from irdu_tpu.ops.pallas.pixel_nhwc import RADIUS_W, _halos
from irdu_tpu.ops.pallas.pixel_nhwc import pixel_segment_nhwc as jax_segment
from irdu_tpu.ops.pallas.solver_unroll import gg_pixel_unroll_chw as jax_pixel_unroll
from irdu_tpu.ops.pallas.solver_unroll import pixel_unroll_scal as jax_pixel_scal
from irdu_tpu_torch.ops import fused_step as fs
from irdu_tpu_torch.ops import pixel_nhwc as pn
from irdu_tpu_torch.ops import pixel_unroll as pu
from irdu_tpu_torch.ops.windows import (CROSS4, DIAMOND12, RING8, WINDOW_CODES, WINDOWS,
                                        window_code, window_radius)
from test_torch_fused_step import box_at, pad_box, padded_tile_term, zero_box

SMEM_LIMIT = 232448  # 227 KB a CTA
NEW_WINDOWS = {"cross4": CROSS4, "ring8": RING8}  # the pixel family's windows beside diamond-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _softmax(rng, shape, axis):
    z = rng.randn(*shape)
    ex = np.exp(z - z.max(axis=axis, keepdims=True))
    return (ex / ex.sum(axis=axis, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["cross4", "diamond12", "ring8"])
def test_window_codes_and_radii(name):
    """Each window's edge order is JAX's; its code is the kernels' (Win<> in
    padded_tile.cuh: 0 cross-4, 1 diamond-12, 2 ring-8) and its radius the
    rows it reads."""
    deltas = WINDOWS[name]
    assert deltas == tuple(tuple(d) for d in jax_windows.window_to_deltas(
        getattr(jax_windows, f"WINDOW_{name.upper()}")))
    assert window_code(deltas) == {"cross4": 0, "diamond12": 1, "ring8": 2}[name]
    assert window_code([list(d) for d in deltas]) == WINDOW_CODES[deltas]
    assert window_radius(deltas) == (2 if name == "diamond12" else 1)


# ---------------------------------------------------------------------------
# K7: the whole CHW unroll on cross-4 and ring-8
# ---------------------------------------------------------------------------

G7, F7 = 4, 3
# the kernel's phases (pixel_unroll.cu), as tests/test_torch_pixel_unroll_phases.py
# lists them: kind, the plane read over a box, the planes read at the pixels
# (rhs, prev), the planes written (output, CG update), scal's alpha and beta
PHASES = (
    ("rhs", "y", None, None, "P0", None, None, None),
    ("cg_first", "P0", None, None, "P1", "P2", 3, None),
    ("cg_next", "P1", "P0", "P2", "P0", None, 4, 7),
    ("rethresh", "P0", None, None, "P1", None, None, None),
    ("cg_first", "P1", None, None, "P0", "P2", 5, None),
    ("cg_next", "P0", "P1", "P2", "out", None, 6, 8),
)


def _k7_inputs(deltas, h, w, g, seed):
    """ỹ (1, F, h, w) U[0, 1); softmax weights of the window; stencils near
    (1, ½, ½, ½); μ, ρ U(0.2, 0.3), γ U(0.02, 0.03), α ≈ 0.5, β ≈ 0.1."""
    rng = np.random.RandomState(seed)
    e = len(deltas)
    y = rng.rand(1, F7, h, w).astype(np.float32)
    wg, wl = (_softmax(rng, (1, g, e, h, w), 2) for _ in range(2))
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    pg, pl = ((inits + 0.3 * rng.randn(g, 4, F7)).astype(np.float32) for _ in range(2))
    coef = ((0.2 + 0.1 * rng.rand(g)).astype(np.float32),
            (0.2 + 0.1 * rng.rand(g)).astype(np.float32),
            (0.02 + 0.01 * rng.rand(g)).astype(np.float32),
            (0.5 + 0.1 * rng.randn(4, g)).astype(np.float32),
            (0.1 + 0.05 * rng.randn(4, g)).astype(np.float32))
    return y, wg, wl, pg, pl, coef


def phased_unroll(y, wg, wl, pg, pl, scal, n_graphs, tile, deltas):
    """K7 as pixel_unroll.cu computes it on ``deltas``, f32, batch 1, on
    ``tile``: the phases in order (the grid barriers), each over the (graph,
    tile) items in launch order, each item walking its F planes with its
    weight boxes staged once; stage planes with halo 1 + r rows and that
    rounded up to a multiple of 4 columns, the f32 x box with 2 + r rows and
    4 columns. Every plane starts as NaN and is written in place."""
    _, f_n, h, w = y.shape
    th, tw = tile
    hs = 1 + window_radius(deltas)
    hsc, hxr, hxc = (hs + 3) & ~3, hs + 1, 4
    geo = dict(th=th, tw=tw, hs=hs, hsc=hsc)
    planes = {k: torch.full((1, n_graphs * f_n, h, w), float("nan"))
              for k in ("P0", "P1", "P2", "out")}
    for kind, xs, rhs_k, prev_k, o_k, u_k, a_col, b_col in PHASES:
        glr = kind.startswith("cg")
        for g in range(n_graphs):
            mu, ro, gam = scal[g, 0:1], scal[g, 1:2], scal[g, 2:3]
            for i0 in range(0, h, th):
                for j0 in range(0, w, tw):
                    i1, j1 = min(i0 + th, h), min(j0 + tw, w)
                    wgb = zero_box(wg[0, g], i0 - hs, j0 - hsc, th + 2 * hs, tw + 2 * hsc)[None]
                    wlb = (zero_box(wl[0, g], i0 - hs, j0 - hsc, th + 2 * hs, tw + 2 * hsc)[None]
                           if glr else None)
                    xi0, xj0 = i0 - hxr, j0 - hxc
                    for f in range(f_n):
                        ch = g * f_n + f
                        src = y[0, f] if xs == "y" else planes[xs][0, ch]
                        xb = pad_box(src, xi0, xj0, th + 2 * hxr, tw + 2 * hxc, True)[None]

                        def taps(di, dj, rows, cols, xb=xb):
                            ci = (i0 - hs + rows).clamp(0, h - 1) - xi0
                            cj = (j0 - hsc + cols).clamp(0, w - 1) - xj0
                            return box_at(xb, ci + di, cj + dj)

                        t = padded_tile_term(geo, taps, wgb, wlb, pg[g, :, f][None],
                                             pl[g, :, f][None] if glr else None, ro, mu,
                                             gam if kind == "rethresh" else None, i0, j0, h, w,
                                             deltas)[0, :i1 - i0, :j1 - j0]
                        xv = xb[0, hxr:hxr + i1 - i0, hxc:hxc + j1 - j0]
                        sl = (0, ch, slice(i0, i1), slice(j0, j1))
                        if kind == "rhs":
                            o = xv + t
                        elif kind == "rethresh":
                            o = y[0, f, i0:i1, j0:j1] + t
                        elif kind == "cg_first":
                            u = -t
                            planes[u_k][sl] = u
                            o = xv + scal[g, a_col] * u
                        else:
                            u = (planes[rhs_k][sl] - (xv + t)
                                 + scal[g, b_col] * planes[prev_k][sl])
                            o = xv + scal[g, a_col] * u
                        planes[o_k][sl] = o
    return planes["out"]


@pytest.mark.parametrize("name", list(NEW_WINDOWS))
def test_pixel_unroll_window_matches_jax_kernel(name):
    """The port's K7 (the plain version on the CPU) against JAX's
    ``gg_pixel_unroll_chw`` in interpret mode at 16x128, G = 4."""
    deltas = NEW_WINDOWS[name]
    y, wg, wl, pg, pl, coef = _k7_inputs(deltas, 16, 128, G7, seed=len(name))
    scal = np.asarray(jax_pixel_scal(G7, *coef))
    ref = np.asarray(jax_pixel_unroll(_j(y), _j(wg), _j(wl), _j(pg), _j(pl), _j(scal),
                                      n_graphs=G7, deltas=deltas, interpret=True))
    before = pu.gg_pixel_unroll_chw.launches
    out = pu.gg_pixel_unroll_chw(_t(y), _t(wg), _t(wl), _t(pg), _t(pl), _t(scal), n_graphs=G7,
                                 deltas=deltas).numpy()
    assert pu.gg_pixel_unroll_chw.launches == before, "a CPU tensor must not launch"
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - np.tile(y, (1, G7, 1, 1))).max() > 0.05


@pytest.mark.parametrize("tile,hw,g", [((16, 64), (20, 70), 2), ((32, 64), (35, 66), 1)],
                         ids=["16x64_f32_tile", "32x64_bf16_tile"])
@pytest.mark.parametrize("name", list(NEW_WINDOWS))
def test_pixel_unroll_window_phase_scheme_matches_plain(name, tile, hw, g):
    """K7's six phases on the window over ragged tiles on every edge, each
    dtype's tile (K7_TILES): the plain unroll's result, every output written
    and no uncomputed or overwritten cell read."""
    deltas = NEW_WINDOWS[name]
    y, wg, wl, pg, pl, coef = _k7_inputs(deltas, *hw, g, seed=sum(hw))
    scal = pu.pixel_unroll_scal(g, *map(_t, coef))
    args = (_t(y), _t(wg), _t(wl), _t(pg), _t(pl), scal)
    out = phased_unroll(*args, g, tile, deltas)
    want = pu.pixel_unroll_plain(*args, n_graphs=g, deltas=deltas)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# K8: the NHWC segments on cross-4 and ring-8
# ---------------------------------------------------------------------------

G8, F8 = 4, 3
SEGMENTS = {"rhs": (False, False, False), "cg1": (False, False, True),
            "cg2": (True, True, True), "rethresh": (True, False, False)}  # aux, prev, w_glr


def _k8_inputs(deltas, h, w, g, seed):
    """x, aux U[0, 1), prev 0.3·N(0, 1) (1, h, w, F·G); packed softmax
    weights of the window; p (2, 4); one CG step's (5, C) planar rows."""
    rng = np.random.RandomState(seed)
    e, c = len(deltas), F8 * g
    x, aux = (rng.rand(1, h, w, c).astype(np.float32) for _ in range(2))
    prev = (0.3 * rng.randn(1, h, w, c)).astype(np.float32)
    wg, wl = (_softmax(rng, (1, h, w, e, g), 3).reshape(1, h, w, e * g) for _ in range(2))
    p = (np.array([[1.0, 0.5, 0.5, 0.5]]) + 0.2 * rng.randn(2, 4)).astype(np.float32)
    rows = np.stack([np.tile(v, F8) for v in (
        0.2 + 0.1 * rng.rand(g), 0.2 + 0.1 * rng.rand(g), 0.02 + 0.01 * rng.rand(g),
        0.5 + 0.1 * rng.randn(g), 0.1 + 0.05 * rng.randn(g))]).astype(np.float32)
    return x, aux, prev, wg, wl, p, rows


def _segment_args(mode, x, aux, prev, wg, wl, p, rows):
    use_aux, use_prev, use_glr = SEGMENTS[mode]
    return (x, aux if use_aux else None, prev if use_prev else None, wg,
            wl if use_glr else None, p, rows)


def tiled_segment(x, aux, prev, wg, wl, p, scal, mode, plan, n_graphs, deltas):
    """K8 as pixel_nhwc.cu computes it on ``deltas``, f32, batch 1, with the
    tile plan ``plan`` (``K8_PLANS``): the tiles in launch order, each
    tile's groups of graphs (the last partial where the group size does not
    divide G), the group's weight boxes once (halo 1 + r, zero outside the
    image), each feature's x box (halo 2 + r, the reflect pad) through the
    padded tile."""
    th, tw, lanes, _ = pn.K8_PLANS[plan]
    _, h, w, c = x.shape
    f_n, n_e = c // n_graphs, len(deltas)
    hs = 1 + window_radius(deltas)
    hx = hs + 1
    geo = dict(th=th, tw=tw, hs=hs, hsc=hs)
    glr = mode in ("cg1", "cg2")

    def per_graph(packed):  # (1, H, W, E·G) → (G, E, H, W)
        return packed[0].reshape(h, w, n_e, n_graphs).permute(3, 2, 0, 1)

    wgv = per_graph(wg)
    wlv = per_graph(wl) if glr else None
    xc = x[0].permute(2, 0, 1)
    mu, ro, gamma, alpha, beta = scal
    out, upd = torch.full_like(x, float("nan")), torch.full_like(x, float("nan"))
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            i1, j1 = min(i0 + th, h), min(j0 + tw, w)
            for g0 in range(0, n_graphs, lanes):
                gs = list(range(g0, min(g0 + lanes, n_graphs)))
                wgb = zero_box(wgv[gs], i0 - hs, j0 - hs, th + 2 * hs, tw + 2 * hs)
                wlb = zero_box(wlv[gs], i0 - hs, j0 - hs, th + 2 * hs, tw + 2 * hs) if glr else None
                for f in range(f_n):
                    chs = [f * n_graphs + g for g in gs]
                    xb = pad_box(xc[chs], i0 - hx, j0 - hx, th + 2 * hx, tw + 2 * hx, True)

                    def taps(di, dj, rows, cols, xb=xb):
                        ci = (i0 - hs + rows).clamp(0, h - 1) - (i0 - hx)
                        cj = (j0 - hs + cols).clamp(0, w - 1) - (j0 - hx)
                        return box_at(xb, ci + di, cj + dj)

                    lp = [p[k].expand(len(gs), 4) for k in range(2)]
                    t = padded_tile_term(geo, taps, wgb, wlb, lp[0], lp[1], ro[chs], mu[chs],
                                         gamma[chs] if mode == "rethresh" else None, i0, j0,
                                         h, w, deltas)
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
@pytest.mark.parametrize("name", list(NEW_WINDOWS))
def test_pixel_segment_window_matches_jax_kernel(name, mode):
    """The port's K8 (the plain version on the CPU) against JAX's
    ``pixel_segment_nhwc`` in interpret mode at 16x128, G = 4."""
    deltas = NEW_WINDOWS[name]
    args = _segment_args(mode, *_k8_inputs(deltas, 16, 128, G8, seed=len(name + mode)))
    halos = (_halos(_j(args[3]), 16, RADIUS_W),
             _halos(_j(args[4] if args[4] is not None else args[3]), 16, RADIUS_W))
    ref = jax_segment(*map(_j, args[:5]), halos, *map(_j, args[5:]), mode=mode, tile_h=16,
                      n_graphs=G8, deltas=deltas, interpret=True)
    before = pn.pixel_segment_nhwc.launches
    out = pn.pixel_segment_nhwc(*map(_t, args), mode=mode, n_graphs=G8, deltas=deltas)
    assert pn.pixel_segment_nhwc.launches == before, "a CPU tensor must not launch"
    outs, refs = (out, ref) if mode == "cg1" else ((out,), (ref,))
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)
    base = args[1] if mode == "rethresh" else args[0]
    assert np.abs(np.asarray(refs[0]) - base).max() > 0.05


@pytest.mark.parametrize("plan,g,hw", [(1, 4, (20, 36)), (0, 3, (19, 37))],
                         ids=["16x32_4graphs", "16x32_2graphs_partial_group"])
@pytest.mark.parametrize("mode", list(SEGMENTS))
@pytest.mark.parametrize("name", list(NEW_WINDOWS))
def test_pixel_segment_window_tiling_matches_plain(name, mode, plan, g, hw):
    """K8's tiling on the window (the served plan of 4 graphs; plan 0 with a
    partial last group) over ragged tiles: the plain segment's result, no
    uncomputed cell read."""
    deltas = NEW_WINDOWS[name]
    args = _segment_args(mode, *map(_t, _k8_inputs(deltas, *hw, g, seed=sum(hw) + g)))
    got = tiled_segment(*args, mode, plan, g, deltas)
    want = pn.pixel_segment_plain(*args, mode=mode, n_graphs=g, deltas=deltas)
    for g_, w_ in zip(*((got, want) if mode == "cg1" else ((got,), (want,)))):
        torch.testing.assert_close(g_, w_, atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the planners, per window; the wrappers' window rule on the launch route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cross4", "diamond12", "ring8"])
def test_planner_smem_per_window_fits_the_card(name):
    """K5 (each scale count and dtype, GLR on), K7 (each dtype's tile) and
    K8 (each built plan) fit a CTA on the window; the radius-1 windows take
    less than diamond-12 at the same tile, and the sizes the kernels'
    comments state hold."""
    code = WINDOW_CODES[WINDOWS[name]]
    d12 = WINDOW_CODES[DIAMOND12]
    for two in (True, False):
        for esize in (4, 2):
            assert fs.k5_smem_bytes(code, two, True, esize) <= SMEM_LIMIT
    for dtype in (torch.bfloat16, torch.float32):
        assert pu.k7_smem_bytes(dtype, code) <= SMEM_LIMIT
        assert pu.k7_smem_bytes(dtype, code) <= pu.k7_smem_bytes(dtype, d12)
    for plan in range(len(pn.K8_PLANS)):
        for esize in ((2, 4) if plan == 0 else (2,)):
            assert pn.k8_smem_bytes(True, plan, esize, code) <= SMEM_LIMIT
            assert pn.k8_smem_bytes(True, plan, esize, code) <= pn.k8_smem_bytes(
                True, plan, esize, d12)
    bf16_cg = {"cross4": 105536, "diamond12": 229376, "ring8": 151616}[name]
    assert pn.k8_smem_bytes(True, pn.K8_PLAN, 2, code) == bf16_cg  # pixel_nhwc.cu's comment


@pytest.mark.parametrize("kernel", ["k5", "k7", "k8"])
def test_launch_route_refuses_a_window_it_is_not_built_for(kernel):
    """On the launch route (a meta-device tensor stands for the card) each
    wrapper raises for a window outside WINDOW_CODES instead of computing
    anything else."""
    full5 = tuple((dh, dw) for dh in range(-2, 3) for dw in range(-2, 3) if (dh, dw) != (0, 0))
    e, g, f, h, w = len(full5), 2, 3, 8, 8
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="window"):
        if kernel == "k5":
            x = torch.empty(1, g * f, h, w, **meta)
            fs.gg_fused_step_chw(x, None, None, torch.empty(1, g, e, h, w, **meta), None, None,
                                 None, None, None, None, None, torch.empty(g, 8, **meta),
                                 mode="rhs", n_graphs=g, deltas=full5)
        elif kernel == "k7":
            wt = torch.empty(1, g, e, h, w, **meta)
            pu.gg_pixel_unroll_chw(torch.empty(1, f, h, w, **meta), wt, wt, None, None,
                                   torch.empty(g, 9, **meta), n_graphs=g, deltas=full5)
        else:
            x = torch.empty(1, h, w, f * g, **meta)
            pn.pixel_segment_nhwc(x, None, None, torch.empty(1, h, w, e * g, **meta), None,
                                  torch.empty(2, 4, **meta), torch.empty(5, f * g, **meta),
                                  mode="rhs", n_graphs=g, deltas=full5)
