"""K5, K6a and K6b (``irdu_tpu_torch/ops/fused_step.py``) of the port against
the JAX package's Pallas kernels in interpret mode, at the shape class of
tests/test_solver_chw.py, and the CUDA kernels' tiling schemes run in PyTorch
against the plain version: K1's tile step (each tile with a 4-pixel halo per
scale, derived planes read through a clamp to the region, zeros outside the
image by global index) and the padded tile of K5, which K6a and K6b launch
single-scale with their own epilogues."""

from __future__ import annotations

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_chw import fused_scal as jax_fused_scal
from irdu_tpu.ops.pallas.solver_chw import gg_fused_step_chw as jax_step
from irdu_tpu.ops.pallas.solver_chw import gg_matvec_chw as jax_matvec
from irdu_tpu.ops.pallas.solver_chw import gtv_rethresh_chw as jax_rethresh
from irdu_tpu_torch.ops import fused_step as fs
from irdu_tpu_torch.ops.windows import CROSS4

G, F = 2, 3
C = G * F
H, W = 32, 24  # the two-scale step: H % 16 == 0 on the TPU


def _softmax_weights(rng, h, w):
    z = rng.randn(1, G, 4, h, w)
    e = np.exp(z - z.max(axis=2, keepdims=True))
    return (e / e.sum(axis=2, keepdims=True)).astype(np.float32)


def _inputs(seed, h=H, w=W):
    """x, aux, prev (1, C, h, w); the four weight planes; four stats tables;
    the per-graph scalars, as the JAX tests draw them."""
    rng = np.random.RandomState(seed)
    planes = [(rng.randn(1, C, h, w) * s).astype(np.float32) for s in (1.0, 0.5, 0.5)]
    ws = [_softmax_weights(rng, h, w), _softmax_weights(rng, h, w),
          _softmax_weights(rng, h // 2, w // 2), _softmax_weights(rng, h // 2, w // 2)]
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    tables = [(inits + 0.3 * rng.randn(G, 4, F)).astype(np.float32) for _ in range(4)]

    def mk(lo):
        return (rng.rand(G) + lo).astype(np.float32)

    s = dict(mu0=mk(0.1), ro0=mk(0.1), mu1=mk(0.05), ro1=mk(0.05), alpha=mk(0.2),
             beta=mk(0.1), gamma0=mk(0.05) * 0.5, gamma1=mk(0.05) * 0.5)
    return planes, ws, tables, s


def _both(a):
    return (None, None) if a is None else (jnp.asarray(a), torch.from_numpy(a))


# mode, (aux, prev) given, keyword arguments, two-scale, atol (the JAX tests')
STEP_CASES = {
    "rhs": ("rhs", (False, False), {}, True, 2e-4),
    "cg_prev_emit_update": ("cg", (True, True), dict(emit_update=True), True, 3e-4),
    "cg_use_x_rhs": ("cg", (False, False), dict(use_x_rhs=True), True, 3e-4),
    "rethresh_y": ("rethresh", (True, False), {}, True, 2e-4),
    "rethresh_no_y": ("rethresh", (False, False), {}, True, 2e-4),
    "cg_single_scale": ("cg", (True, False), {}, False, 3e-4),
    "rhs_no_stats": ("rhs", (False, False), {}, True, 2e-4),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fused_step_matches_jax_kernel(case):
    mode, (has_aux, has_prev), kw, two_scale, atol = STEP_CASES[case]
    (x, aux, prev), ws, tables, s = _inputs(seed=len(case))
    if not two_scale:
        ws, tables = ws[:2] + [None, None], tables[:2] + [None, None]
    if case.endswith("no_stats"):
        tables = [None] * 4
    scal = np.array(jax_fused_scal(G, **s))
    args = [x, aux if has_aux else None, prev if has_prev else None, *ws, *tables, scal]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_step(*jargs, mode=mode, n_graphs=G, true_h=H, true_w=W, interpret=True, **kw)
    before = fs.gg_fused_step_chw.launches
    out = fs.gg_fused_step_chw(*targs, mode=mode, n_graphs=G, **kw)
    assert fs.gg_fused_step_chw.launches == before, "a CPU tensor must not launch"
    refs, outs = (ref, out) if kw.get("emit_update") else ((ref,), (out,))
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.shape == x.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol)


def test_fused_scal_matches_jax_layout():
    _, _, _, s = _inputs(seed=1)
    for keys in (tuple(s), ("ro0", "ro1"), ("ro0", "ro1", "gamma0", "gamma1")):
        sub = {k: s[k] for k in keys}
        np.testing.assert_array_equal(
            fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in sub.items()}).numpy(),
            np.asarray(jax_fused_scal(G, **sub)))


@pytest.mark.parametrize("with_glr,add_identity,stats", [
    (True, True, True), (True, False, True), (False, True, True), (False, False, True),
    (True, False, False)], ids=["glr_identity", "glr", "gtv_identity", "gtv", "no_stats"])
def test_matvec_matches_jax_kernel(with_glr, add_identity, stats):
    (x, _, _), ws, tables, s = _inputs(seed=10 + 2 * with_glr + add_identity)
    pglr, pgtv = (tables[1], tables[0]) if stats else (None, None)
    args = [x, ws[1], ws[0], pglr, pgtv, s["mu0"], s["ro0"]]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_matvec(*jargs, n_graphs=G, true_h=H, true_w=W, add_identity=add_identity,
                     with_glr=with_glr, interpret=True)
    before = fs.gg_matvec_chw.launches
    out = fs.gg_matvec_chw(*targs, n_graphs=G, add_identity=add_identity, with_glr=with_glr)
    assert fs.gg_matvec_chw.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("with_y,stats", [(True, True), (False, True), (True, False)],
                         ids=["y", "no_y", "y_no_stats"])
def test_rethresh_matches_jax_kernel(with_y, stats):
    (x, y, _), ws, tables, s = _inputs(seed=20 + with_y + 2 * stats)
    gamma = (np.random.RandomState(3).rand(G) * 0.5 + 0.05).astype(np.float32)
    args = [x, y if with_y else None, ws[0], tables[0] if stats else None, gamma, s["ro0"]]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_rethresh(*jargs, n_graphs=G, true_h=H, true_w=W, interpret=True)
    before = fs.gtv_rethresh_chw.launches
    out = fs.gtv_rethresh_chw(*targs, n_graphs=G)
    assert fs.gtv_rethresh_chw.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("what", ["reflect", "diamond12", "mode", "emit_rhs", "odd_w",
                                  "weights", "no_aux"])
def test_fused_step_rejects_what_it_does_not_take(what):
    (x, aux, _), ws, tables, s = _inputs(seed=4, h=16, w=8)
    args = [torch.from_numpy(a) for a in (x, aux, *ws, *tables)]
    args.insert(2, None)
    scal = fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in s.items()})
    kw, err = dict(mode="cg", n_graphs=G), ValueError
    if what == "reflect":  # "edge" and "reflect" are taken; any other pad is not
        kw["stats_mode"] = "symmetric"
    elif what == "diamond12":  # a 5-edge window against 4-edge weights
        kw["deltas"] = CROSS4 + ((2, 0),)
    elif what == "mode":
        kw["mode"] = "matvec"
    elif what == "emit_rhs":
        kw.update(mode="rhs", emit_update=True)
    elif what == "odd_w":
        args[0], args[1] = args[0][..., :7], args[1][..., :7]
    elif what == "weights":
        args[4] = args[4][..., :-1]
    else:
        args[1] = None
    with pytest.raises(err):
        fs.gg_fused_step_chw(*args, scal, **kw)


# ---------------------------------------------------------------------------
# the CUDA tile step (kernels/csrc/tile_step.cuh) of K1, transliterated:
# each output tile of each channel plane with a 4-pixel halo per scale,
# derived planes read through a clamp to the region, zeros outside the image
# by global index, on any window and stencil pad
# (tests/test_torch_solver_unroll.py and test_torch_unroll_windows.py import
# tiled_step)
# ---------------------------------------------------------------------------

HALO = 4


class _Region:
    """Rows [r0, r1) and columns [c0, c1) of an h x w plane: a tile of
    [i0, i1) x [j0, j1) with HALO pixels, clipped to the image."""

    def __init__(self, i0, i1, j0, j1, h, w):
        self.r0, self.r1 = max(i0 - HALO, 0), min(i1 + HALO, h)
        self.c0, self.c1 = max(j0 - HALO, 0), min(j1 + HALO, w)
        self.h, self.w = h, w
        self.grid = torch.meshgrid(torch.arange(self.r0, self.r1),
                                   torch.arange(self.c0, self.c1), indexing="ij")

    def at(self, a, i, j):  # a region plane read at (i, j) clamped to the region
        return a[i.clamp(self.r0, self.r1 - 1) - self.r0, j.clamp(self.c0, self.c1 - 1) - self.c0]

    def inside(self, i, j):  # in the image
        return (i >= 0) & (i < self.h) & (j >= 0) & (j < self.w)


def _stats(reg, a, p, i, j, pad="edge"):
    """The stencil with its pad: "edge" (the clamp), "zero" (0 outside the
    image) or "reflect" (the neighbour on the other side)."""
    def tap(di, dj):
        ii, jj = i + di, j + dj
        if pad == "reflect":
            ii = torch.where(ii < 0, -ii, torch.where(ii >= reg.h, 2 * (reg.h - 1) - ii, ii))
            jj = torch.where(jj < 0, -jj, torch.where(jj >= reg.w, 2 * (reg.w - 1) - jj, jj))
        val = reg.at(a, ii, jj)
        return torch.where(reg.inside(ii, jj), val, 0.0) if pad == "zero" else val

    v, r, d, u, l = reg.at(a, i, j), tap(0, 1), tap(1, 0), tap(-1, 0), tap(0, -1)
    return p[0] * v + p[1] * (r - v) + p[2] * (d - v) + p[3] * (4 * v - u - d - l - r)


def _stats_t(reg, a, p, i, j):
    def z(di, dj):
        return torch.where(reg.inside(i + di, j + dj), reg.at(a, i + di, j + dj), 0.0)

    v, r0, d0, u0, l0 = reg.at(a, i, j), z(0, 1), z(1, 0), z(-1, 0), z(0, -1)
    return p[0] * v + p[1] * (l0 - v) + p[2] * (u0 - v) + p[3] * (4 * v - u0 - d0 - l0 - r0)


def _edge_map(eps, gamma):
    if gamma is None:
        return eps
    thr = (torch.where(eps < -gamma, eps + gamma, 0.0)
           + torch.where(eps > gamma, eps - gamma, 0.0))
    return 2 * thr - eps


def _gtv_edge_sum(reg, s, w, i, j, gamma, deltas=CROSS4):
    sp, acc = reg.at(s, i, j), 0.0
    for e, (dh, dw) in enumerate(deltas):
        wp = w[e][i, j]
        acc = acc + wp * _edge_map(wp * (sp - reg.at(s, i + dh, j + dw)), gamma)
        qi, qj = i - dh, j - dw
        wq = w[e][qi.clamp(0, reg.h - 1), qj.clamp(0, reg.w - 1)]
        nbr = wq * _edge_map(wq * (reg.at(s, qi, qj) - sp), gamma)
        acc = acc - torch.where(reg.inside(qi, qj), nbr, 0.0)
    return acc


def _glr_lap(reg, s, w, i, j, deltas=CROSS4):
    acc = sum(w[e][i, j] * reg.at(s, i + dh, j + dw) for e, (dh, dw) in enumerate(deltas))
    return reg.at(s, i, j) - acc


def _scale_term(reg, x_reg, w_gtv, w_glr, pg, pl, ro, mu, gamma, ti, tj, deltas=CROSS4,
                pad="edge"):
    """ρ·(statsᵀ of the edge sums) [+ μ·GLR] at the tile's pixels (ti, tj):
    the kernel's stages 2-4 (or 2, 3, 5) on one scale, on the window
    ``deltas`` with the stencil padded by ``pad``."""
    i, j = reg.grid
    ag = _gtv_edge_sum(reg, _stats(reg, x_reg, pg, i, j, pad), w_gtv, i, j, gamma, deltas)
    t = ro * _stats_t(reg, ag, pg, ti, tj)
    if w_glr is not None:
        al = _glr_lap(reg, _stats(reg, x_reg, pl, i, j, pad), w_glr, i, j, deltas)
        t = t + mu * _stats_t(reg, al, pl, ti, tj)
    return t


def tiled_step(x, aux, prev, ws, tables, scal, mode, th, tw, n_graphs, use_x_rhs=False,
               x_add=None, deltas=CROSS4, pad="edge"):
    """One step tile by tile as the kernel computes it, f32, batch 1, on
    x (or x + scal's x_coef · x_add, K1's third step); scal (G, 8) as
    ``fused_scal`` lays it out, or (G, 9) with x_coef last; the window
    ``deltas`` (the weights' E planes) and the stencil's ``pad``. Returns
    (out, upd)."""
    _, c, h, w = x.shape
    f = c // n_graphs
    out, upd = torch.empty_like(x), torch.empty_like(x)
    for ch in range(c):
        g = ch // f
        sc = scal[g]
        mu0, ro0, mu1, ro1, alpha, beta, gam0, gam1 = sc[:8]
        xc = x[0, ch] if x_add is None else x[0, ch] + sc[8] * x_add[0, ch]
        rethresh = mode == "rethresh"
        glr = mode == "cg"
        tab = [t[g, :, ch % f] for t in tables]  # pg0, pl0, pg1, pl1
        wt = [wt_[0, g] for wt_ in ws]
        for i0 in range(0, h, th):
            for j0 in range(0, w, tw):
                i1, j1 = min(i0 + th, h), min(j0 + tw, w)
                ti, tj = torch.meshgrid(torch.arange(i0, i1), torch.arange(j0, j1),
                                        indexing="ij")
                r0 = _Region(i0, i1, j0, j1, h, w)
                xr = xc[r0.r0:r0.r1, r0.c0:r0.c1]
                t = _scale_term(r0, xr, wt[0], wt[1] if glr else None, tab[0], tab[1],
                                ro0, mu0, gam0 if rethresh else None, ti, tj, deltas, pad)
                r1 = _Region(i0 // 2, i1 // 2, j0 // 2, j1 // 2, h // 2, w // 2)
                xd = xc[2 * r1.r0:2 * r1.r1, 2 * r1.c0:2 * r1.c1]
                xd = 0.25 * (xd[0::2, 0::2] + xd[0::2, 1::2] + xd[1::2, 0::2] + xd[1::2, 1::2])
                t1 = _scale_term(r1, xd, wt[2], wt[3] if glr else None, tab[2], tab[3], ro1,
                                 mu1, gam1 if rethresh else None, ti // 2, tj // 2, deltas, pad)
                t = t + 0.25 * t1
                xv = xc[i0:i1, j0:j1]
                sl = (0, ch, slice(i0, i1), slice(j0, j1))
                if mode == "rhs":
                    out[sl] = xv + t
                elif mode == "rethresh":
                    out[sl] = t if aux is None else t + aux[sl]
                else:
                    u = (xv if use_x_rhs else aux[sl]) - (xv + t)
                    if prev is not None:
                        u = u + beta * prev[sl]
                    upd[sl], out[sl] = u, xv + alpha * u
    return out, upd


@pytest.mark.parametrize("mode", ["rhs", "cg", "rethresh"])
@pytest.mark.parametrize("th,tw", [(8, 12), (6, 10), (32, 64)],
                         ids=["8x12_ragged", "6x10_odd_half_tiles", "one_tile"])
def test_kernel_tiling_scheme_matches_plain(mode, th, tw):
    """20x28 plane: tiles on every image edge, interior tiles, ragged last
    tiles, half tiles of odd size; the result equals the plain step."""
    (x, aux, prev), ws, tables, s = _inputs(seed=30, h=20, w=28)
    t = [torch.from_numpy(a) for a in (x, aux, prev, *ws, *tables)]
    x, aux, prev, ws, tables = t[0], t[1], t[2], t[3:7], t[7:]
    scal = fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in s.items()})
    aux_m = None if mode == "rhs" else aux
    prev_m = prev if mode == "cg" else None
    out, upd = tiled_step(x, aux_m, prev_m, ws, tables, scal, mode, th, tw, G)
    want = fs.fused_step_plain(x, aux_m, prev_m, *ws, *tables, scal, mode=mode, n_graphs=G,
                               emit_update=mode == "cg")
    if mode == "cg":
        torch.testing.assert_close(upd, want[1], atol=1e-5, rtol=1e-5)
        want = want[0]
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K5's padded tile (kernels/csrc/fused_step_hopper.cu, padded_tile.cuh),
# transliterated: a CTA per tile and graph walking the F planes, the tile's
# weights of both scales boxed once (zero outside the image), each plane's x
# box with the stencil's pad, stage planes over boxes not clipped to the
# image (S at the clamped pixel, A zero outside it), read by unclamped
# offsets. Cells the kernel does not compute hold NaN, so a read of one
# shows in the result. tests/test_torch_fused_step_pixel.py and
# tests/test_torch_pixel_kernels.py (K8) import these.
# ---------------------------------------------------------------------------


def pad_index(i, n, reflect):
    """The pixel a pad reads for the indices ``i`` of an axis of n."""
    if reflect:
        i = torch.where(i < 0, -i, torch.where(i >= n, 2 * (n - 1) - i, i))
    return i.clamp(0, n - 1)


def zero_box(planes, r0, c0, nr, nc):
    """(..., H, W) → (..., nr, nc) cells from (r0, c0), zero outside."""
    h, w = planes.shape[-2:]
    i, j = torch.arange(r0, r0 + nr), torch.arange(c0, c0 + nc)
    inside = ((i >= 0) & (i < h))[:, None] & ((j >= 0) & (j < w))[None, :]
    return planes[..., i.clamp(0, h - 1)[:, None], j.clamp(0, w - 1)[None, :]] * inside


def pad_box(planes, r0, c0, nr, nc, reflect):
    """(..., H, W) → (..., nr, nc) cells from (r0, c0), each the pixel the
    pad reads."""
    h, w = planes.shape[-2:]
    i = pad_index(torch.arange(r0, r0 + nr), h, reflect)
    j = pad_index(torch.arange(c0, c0 + nc), w, reflect)
    return planes[..., i[:, None], j[None, :]]


def box_at(a, i, j):
    """a[..., i, j] with row indices i (column) and column indices j (row),
    which must lie in the box: a read past it is a fault of the scheme."""
    assert i.min() >= 0 and i.max() < a.shape[-2] and j.min() >= 0 and j.max() < a.shape[-1]
    return a[..., i[:, None], j[None, :]]


def _stencil(p, v, r, d, u, l):  # p (L, 4); taps (L, rows, cols)
    p = [p[:, k, None, None] for k in range(4)]
    return p[0] * v + p[1] * (r - v) + p[2] * (d - v) + p[3] * (4 * v - u - d - l - r)


def _stencil_t(p, v, r, d, u, l):
    p = [p[:, k, None, None] for k in range(4)]
    return p[0] * v + p[1] * (l - v) + p[2] * (u - v) + p[3] * (4 * v - u - d - l - r)


def padded_tile_term(geo, taps, wg, wl, pg, pl, ro, mu, gamma, i0, j0, h, w, deltas):
    """One scale of the padded tile on L lanes: ρ·statsᵀ(Ag) [+ μ·statsᵀ(Al)]
    on the tile's (L, th, tw) cells. geo: th, tw, hs, hsc (this scale's);
    taps(di, dj, rows, cols): the stencil's input at the plane cells
    (rows, cols) clamped to the image, shifted by (di, dj); wg, wl (L, E,
    PH, PW) weight boxes (wl None without GLR); pg, pl (L, 4); ro, mu,
    gamma (L,) or None; (i0, j0) the tile's first pixel of an h x w image."""
    th, tw, hs, hsc = geo["th"], geo["tw"], geo["hs"], geo["hsc"]
    ph, pw = th + 2 * hs, tw + 2 * hsc
    n_l = pg.shape[0]
    # 2. the stencils over the tile + hs
    rows, cols = torch.arange(ph), torch.arange(hsc - hs, hsc + tw + hs)
    v, r, d, u, l = (taps(di, dj, rows, cols)
                     for di, dj in ((0, 0), (0, 1), (1, 0), (-1, 0), (0, -1)))

    def plane(vals):
        p = torch.full((n_l, ph, pw), float("nan"))
        p[:, :, hsc - hs:hsc + tw + hs] = vals
        return p

    sg = plane(_stencil(pg, v, r, d, u, l))
    sl = plane(_stencil(pl, v, r, d, u, l)) if wl is not None else None
    # 3. the edge sums over the tile + 1, zero outside the image
    ar, ac = torch.arange(hs - 1, hs + th + 1), torch.arange(hsc - 1, hsc + tw + 1)
    gi, gj = i0 - hs + ar, j0 - hsc + ac
    inside = ((gi >= 0) & (gi < h))[:, None] & ((gj >= 0) & (gj < w))[None, :]

    def at(a, dh, dw):  # (L, rows, cols) plane or (L, E, ...) weights at an offset
        return box_at(a, ar + dh, ac + dw)

    def emap(eps):
        if gamma is None:
            return eps
        gm = gamma[:, None, None]
        return 2 * (torch.where(eps < -gm, eps + gm, 0.0)
                    + torch.where(eps > gm, eps - gm, 0.0)) - eps

    sp, acc = at(sg, 0, 0), 0.0
    for e, (dh, dw) in enumerate(deltas):
        wp, wq = at(wg[:, e], 0, 0), at(wg[:, e], -dh, -dw)
        acc = (acc + wp * emap(wp * (sp - at(sg, dh, dw)))
               - wq * emap(wq * (at(sg, -dh, -dw) - sp)))

    def a_plane(vals):
        p = torch.full((n_l, ph, pw), float("nan"))
        p[:, ar[:, None], ac[None, :]] = torch.where(inside, vals, 0.0)
        return p

    ag = a_plane(acc)
    # 4. stats^T on the tile
    tr, tc = torch.arange(hs, hs + th), torch.arange(hsc, hsc + tw)

    def stats_t(a, p):
        def t_at(di, dj):
            return box_at(a, tr + di, tc + dj)

        return _stencil_t(p, t_at(0, 0), t_at(0, 1), t_at(1, 0), t_at(-1, 0), t_at(0, -1))

    t = ro[:, None, None] * stats_t(ag, pg)
    if wl is not None:
        al = at(sl, 0, 0) - sum(at(wl[:, e], 0, 0) * at(sl, dh, dw)
                                for e, (dh, dw) in enumerate(deltas))
        t = mu[:, None, None] * stats_t(a_plane(al), pl) + t
    return t


def padded_step(x, aux, prev, ws, tables, scal, mode, n_graphs, tile=None, deltas=CROSS4,
                reflect=False, use_x_rhs=False):
    """K5 in ``mode`` as fused_step_hopper.cu computes it (``padded_kernel``
    with the arguments ``gg_fused_step_chw`` launches it with). Returns
    (out, upd)."""
    epi = {"rhs": fs._EPI_ADD_X, "rethresh": fs._EPI_ADD_AUX, "cg": fs._EPI_CG}[mode]
    return padded_kernel(x, aux, prev, ws, tables, scal, n_graphs, rethresh=mode == "rethresh",
                         glr=mode == "cg", epi=epi, use_x_rhs=use_x_rhs, tile=tile,
                         deltas=deltas, reflect=reflect)


def padded_kernel(x, aux, prev, ws, tables, scal, n_graphs, *, rethresh, glr, epi,
                  use_x_rhs=False, tile=None, deltas=CROSS4, reflect=False):
    """fused_step_hopper.cu on the arguments of its C entry point, f32,
    batch 1: per graph, the tiles of ``fs.k5_tile`` (or ``tile``, (rows,
    columns): the kernel's template takes any) in launch order
    (row-major), each walking the graph's F planes. ws: w_gtv0, w_glr0,
    w_gtv1, w_glr1 (the half-res pair None single-scale); tables pg0, pl0,
    pg1, pl1; the re-threshold's map with ``rethresh``, the GLR terms with
    ``glr``; ``epi`` the epilogue: x + T, [aux +] T or the CG update.
    Returns (out, upd)."""
    _, c, h, w = x.shape
    f_n = c // n_graphs
    two = ws[2] is not None
    win = fs.KERNEL_WINDOWS[tuple(deltas)]
    geo = fs.k5_geometry(win, two)
    if tile is not None:
        geo = dict(geo, th=tile[0], tw=tile[1])
    th, tw, hs, hsc, hxr, hxc = (geo[k] for k in ("th", "tw", "hs", "hsc", "hxr", "hxc"))
    geo1 = dict(geo, th=th // 2, tw=tw // 2)
    h2, w2 = h // 2, w // 2
    out, upd = torch.full_like(x, float("nan")), torch.full_like(x, float("nan"))
    for g in range(n_graphs):
        mu0, ro0, mu1, ro1, alpha, beta, gam0, gam1 = (v.reshape(1) for v in scal[g])
        for i0 in range(0, h, th):
            for j0 in range(0, w, tw):
                # the tile's weights, once for all F planes
                wb = [None if wt is None or (k % 2 and not glr) else
                      zero_box(wt[0, g], i0 - hs, j0 - hsc, th + 2 * hs, tw + 2 * hsc)[None]
                      if k < 2 else
                      zero_box(wt[0, g], i0 // 2 - hs, j0 // 2 - hsc, th // 2 + 2 * hs,
                               tw // 2 + 2 * hsc)[None]
                      for k, wt in enumerate(ws)]
                xi0, xj0 = i0 - hxr, j0 - hxc
                for f in range(f_n):
                    ch = g * f_n + f
                    xb = pad_box(x[0, ch], xi0, xj0, th + 2 * hxr, tw + 2 * hxc, reflect)[None]
                    tab = [None if t is None else t[g, :, f][None] for t in tables]

                    def taps(di, dj, rows, cols, xb=xb):
                        ci = (i0 - hs + rows).clamp(0, h - 1) - xi0
                        cj = (j0 - hsc + cols).clamp(0, w - 1) - xj0
                        return box_at(xb, ci + di, cj + dj)

                    def taps_half(di, dj, rows, cols, xb=xb):
                        qi = pad_index((i0 // 2 - hs + rows).clamp(0, h2 - 1) + di, h2, reflect)
                        qj = pad_index((j0 // 2 - hsc + cols).clamp(0, w2 - 1) + dj, w2,
                                       reflect)
                        ri, rj = 2 * qi - xi0, 2 * qj - xj0
                        return 0.25 * (box_at(xb, ri, rj) + box_at(xb, ri, rj + 1)
                                       + box_at(xb, ri + 1, rj) + box_at(xb, ri + 1, rj + 1))

                    gam = (gam0, gam1) if rethresh else (None, None)
                    t = padded_tile_term(geo, taps, wb[0], wb[1], tab[0], tab[1], ro0, mu0,
                                         gam[0], i0, j0, h, w, deltas)[0]
                    if two:  # the 2x2 box's half-res term, once per box
                        t1 = padded_tile_term(geo1, taps_half, wb[2], wb[3], tab[2], tab[3],
                                              ro1, mu1, gam[1], i0 // 2, j0 // 2, h2, w2,
                                              deltas)[0]
                        t = t + 0.25 * t1.repeat_interleave(2, 0).repeat_interleave(2, 1)
                    i1, j1 = min(i0 + th, h), min(j0 + tw, w)
                    t = t[:i1 - i0, :j1 - j0]
                    xv = xb[0, hxr:hxr + i1 - i0, hxc:hxc + j1 - j0]
                    sl = (0, ch, slice(i0, i1), slice(j0, j1))
                    if epi == fs._EPI_ADD_X:
                        out[sl] = xv + t
                    elif epi == fs._EPI_ADD_AUX:
                        out[sl] = t if aux is None else t + aux[sl]
                    else:
                        u = (xv if use_x_rhs else aux[sl]) - (xv + t)
                        if prev is not None:
                            u = u + beta * prev[sl]
                        upd[sl], out[sl] = u, xv + alpha * u
    return out, upd


@pytest.mark.parametrize("mode", ["rhs", "cg", "rethresh"])
@pytest.mark.parametrize("tile,hw", [(None, (20, 28)), (None, (36, 132)), ((64, 64), (66, 70))],
                         ids=["32x64_one_ragged_tile", "32x64_ragged_rows_and_columns",
                              "64x64_four_tiles"])
def test_padded_tile_scheme_matches_plain(mode, tile, hw):
    """K5's padded tile, two-scale cross-4 "edge", on its 32x64 tile and on
    64x64 tiles (the template's tile is a parameter): tiles on every image
    edge, ragged last tiles, half tiles against the half image's edge; the
    result equals the plain step and no cell the kernel leaves uncomputed is
    read."""
    h, w = hw
    (x, aux, prev), ws, tables, s = _inputs(seed=40 + (tile is not None), h=h, w=w)
    t = [torch.from_numpy(a) for a in (x, aux, prev, *ws, *tables)]
    x, aux, prev, ws, tables = t[0], t[1], t[2], t[3:7], t[7:]
    scal = fs.fused_scal(G, **{k: torch.from_numpy(v) for k, v in s.items()})
    aux_m = None if mode == "rhs" else aux
    prev_m = prev if mode == "cg" else None
    out, upd = padded_step(x, aux_m, prev_m, ws, tables, scal, mode, G, tile=tile)
    want = fs.fused_step_plain(x, aux_m, prev_m, *ws, *tables, scal, mode=mode, n_graphs=G,
                               emit_update=mode == "cg")
    if mode == "cg":
        torch.testing.assert_close(upd, want[1], atol=5e-4, rtol=1e-3)
        want = want[0]
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", ["cg_prev_emit_update", "rethresh_no_y", "cg_single_scale"])
def test_padded_tile_scheme_matches_jax_kernel(case):
    """The transliteration against JAX's Pallas kernel in interpret mode at
    the JAX tests' shape (32x24: one ragged tile), two-scale and single-scale
    cross-4."""
    mode, (has_aux, has_prev), kw, two_scale, _ = STEP_CASES[case]
    (x, aux, prev), ws, tables, s = _inputs(seed=len(case))
    if not two_scale:
        ws, tables = ws[:2] + [None, None], tables[:2] + [None, None]
    scal = np.array(jax_fused_scal(G, **s))
    args = [x, aux if has_aux else None, prev if has_prev else None, *ws, *tables, scal]
    jargs, targs = zip(*(_both(a) for a in args))
    ref = jax_step(*jargs, mode=mode, n_graphs=G, true_h=H, true_w=W, interpret=True, **kw)
    out, upd = padded_step(targs[0], targs[1], targs[2], targs[3:7], targs[7:11], targs[11],
                           mode, G)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[0] if kw else ref),
                               atol=5e-4, rtol=1e-3)
    if kw.get("emit_update"):
        np.testing.assert_allclose(upd.numpy(), np.asarray(ref[1]), atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# K6a and K6b: single-scale launches of K5's kernel
# ---------------------------------------------------------------------------

# K6a's (matvec) and K6b's (rethresh) variants: wrapper, GLR, identity, y
K6_CASES = {
    "matvec_glr_identity": ("matvec", True, True, False),
    "matvec_glr": ("matvec", True, False, False),
    "matvec_gtv_identity": ("matvec", False, True, False),
    "matvec_gtv": ("matvec", False, False, False),
    "rethresh_y": ("rethresh", False, False, True),
    "rethresh_no_y": ("rethresh", False, False, False),
}


def k6_calls(case, x, y, wg, wl, pg, pl, mu, ro, gamma, n_graphs, **kw):
    """The K6 wrapper of ``case`` and its plain version, each a function of
    x, with the other operands bound (torch tensors; y unused by K6a and
    dropped by K6b without y)."""
    kind, with_glr, identity, with_y = K6_CASES[case]
    if kind == "matvec":
        kw.update(n_graphs=n_graphs, add_identity=identity, with_glr=with_glr)
        return ((lambda v: fs.gg_matvec_chw(v, wl, wg, pl, pg, mu, ro, **kw)),
                (lambda v: fs.matvec_plain(v, wl, wg, pl, pg, mu, ro, **kw)))
    y = y if with_y else None
    kw.update(n_graphs=n_graphs)
    return ((lambda v: fs.gtv_rethresh_chw(v, y, wg, pg, gamma, ro, **kw)),
            (lambda v: fs.rethresh_plain(v, y, wg, pg, gamma, ro, **kw)))


def through_kernel(wrapper, x, n_graphs, tile=None):
    """``wrapper(x)`` as the card runs it: called with x on the meta device
    it takes its launch route, and the launch it asks for (the arguments of
    ``fs._launch``; a None stats table as the identity stencil, as there)
    runs through ``padded_kernel`` on x (on ``tile`` where it is given).
    Returns out."""
    calls = []

    def launch(name, x_, aux, prev, wg0, wl0, wg1, wl1, tables, scal, **kw):
        calls.append((aux, prev, (wg0, wl0, wg1, wl1), tables, scal, kw))
        return torch.empty_like(x_)

    with mock.patch.object(fs, "_launch", launch):
        wrapper(x.to("meta"))
    (aux, prev, ws, tables, scal, kw), = calls
    tables = [fs.identity_table(n_graphs, x.shape[1] // n_graphs) if t is None else t
              for t in tables]
    out, _ = padded_kernel(x, aux, prev, ws, tables, scal, n_graphs, rethresh=kw["rethresh"],
                           glr=kw["glr"], epi=kw["epi"], use_x_rhs=kw.get("use_x_rhs", False),
                           tile=tile, deltas=kw["deltas"],
                           reflect=kw["stats_mode"] == "reflect")
    return out


@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("hw", [(21, 37), (35, 133)],
                         ids=["16x64_one_odd_tile", "16x64_ragged_rows_and_columns"])
def test_k6_padded_tile_matches_plain(case, hw):
    """K6a and K6b on cross-4 "edge", the launch each wrapper asks for run
    through K5's single-scale padded tile (16x64 tiles), odd H and W, tiles
    on every image edge, ragged last tiles: the plain version's result, no
    cell the kernel leaves uncomputed read; and the output moves its input."""
    (x, y, _), ws, tables, s = _inputs(seed=60 + len(case), h=hw[0], w=hw[1])
    x, y, wg, wl, pg, pl, mu, ro, gamma = (torch.from_numpy(a) for a in (
        x, y, ws[0], ws[1], tables[0], tables[1], s["mu0"], s["ro0"], s["gamma0"]))
    wrapper, plain = k6_calls(case, x, y, wg, wl, pg, pl, mu, ro, gamma, G)
    out, want = through_kernel(wrapper, x, G), plain(x)
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)
    base = x if K6_CASES[case][2] else y if K6_CASES[case][3] else 0.0
    assert (want - base).abs().max() > 0.05


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_padded_tile_matches_jax_kernel(case):
    """The launches of K6a and K6b through the padded tile against JAX's
    ``gg_matvec_chw`` and ``gtv_rethresh_chw`` in interpret mode at the JAX
    tests' shape (32x24: two ragged 16x64 tile rows)."""
    kind, with_glr, identity, with_y = K6_CASES[case]
    (x, y, _), ws, tables, s = _inputs(seed=70 + len(case))
    if kind == "matvec":
        args = [x, ws[1], ws[0], tables[1], tables[0], s["mu0"], s["ro0"]]
        jargs, _ = zip(*(_both(a) for a in args))
        ref = jax_matvec(*jargs, n_graphs=G, true_h=H, true_w=W, add_identity=identity,
                         with_glr=with_glr, interpret=True)
    else:
        args = [x, y if with_y else None, ws[0], tables[0], s["gamma0"], s["ro0"]]
        jargs, _ = zip(*(_both(a) for a in args))
        ref = jax_rethresh(*jargs, n_graphs=G, true_h=H, true_w=W, interpret=True)
    xt, yt, wg, wl, pg, pl, mu, ro, gamma = (torch.from_numpy(a) for a in (
        x, y, ws[0], ws[1], tables[0], tables[1], s["mu0"], s["ro0"], s["gamma0"]))
    wrapper, _ = k6_calls(case, xt, yt, wg, wl, pg, pl, mu, ro, gamma, G)
    np.testing.assert_allclose(through_kernel(wrapper, xt, G).numpy(), np.asarray(ref),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("window", [0, 1], ids=["cross4", "diamond12"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k6_smem_bytes_fit_the_card(window, dtype):
    """Every single-scale instance K6a and K6b can launch on ``window`` in
    ``dtype`` (GLR on and off) fits a CTA (227 KB)."""
    esize = 4 if dtype == torch.float32 else 2
    for glr in (False, True):
        assert fs.k5_smem_bytes(window, False, glr, esize) <= 232448


def test_k5_smem_bytes_fit_the_card():
    """K5's shared memory fits a CTA (227 KB) in each dtype; the two-scale
    cross-4 bf16 cg tile fits two CTAs an SM."""
    for two, win in ((True, 0), (False, 0), (False, 1)):
        for esize in (4, 2):
            assert fs.k5_smem_bytes(win, two, True, esize) <= 232448
    assert 2 * (fs.k5_smem_bytes(0, True, True, 2) + 1024) <= 233472
