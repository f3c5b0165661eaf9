"""K7's CUDA kernel (``irdu_tpu_torch/kernels/csrc/pixel_unroll.cu``)
transliterated: the six phases of one cooperative launch, each over every
(graph, tile) item with the padded tile of K5 (tests/test_torch_fused_step.py
``padded_tile_term``), the item walking its F planes with its weight boxes
staged once, and only three f32 scratch planes crossing tile borders. Every
scratch plane and the output start as NaN, and the planes are written in
place in item order, so a read of a cell no phase has written, or of a halo
that the same phase overwrote, shows in the result. Held to the plain unroll
and to JAX's ``gg_pixel_unroll_chw`` in interpret mode at JAX's kernel
tolerance ``atol=5e-4, rtol=1e-3``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_unroll import gg_pixel_unroll_chw as jax_pixel_unroll
from irdu_tpu.ops.pallas.solver_unroll import pixel_unroll_scal as jax_pixel_scal
from irdu_tpu_torch.ops import pixel_unroll as pu
from irdu_tpu_torch.ops.fused_step import identity_table
from irdu_tpu_torch.ops.windows import DIAMOND12
from test_torch_fused_step import box_at, pad_box, padded_tile_term, zero_box

E = len(DIAMOND12)
# the kernel's phases (pixel_unroll.cu): kind, the plane read over a box,
# the planes read at the tile's pixels (rhs, prev), the planes written
# (output, CG update), the scal columns of alpha and beta
PHASES = (
    ("rhs", "y", None, None, "P0", None, None, None),
    ("cg_first", "P0", None, None, "P1", "P2", 3, None),
    ("cg_next", "P1", "P0", "P2", "P0", None, 4, 7),
    ("rethresh", "P0", None, None, "P1", None, None, None),
    ("cg_first", "P1", None, None, "P0", "P2", 5, None),
    ("cg_next", "P0", "P1", "P2", "out", None, 6, 8),
)
SCRATCH = ("P0", "P1", "P2")


def phased_unroll(y, wg, wl, pg, pl, scal, n_graphs, tile=pu.K7_TILES[torch.bfloat16][:2]):
    """K7 as pixel_unroll.cu computes it, f32, batch 1, on ``tile`` (rows,
    columns; the served bf16 tile by default): the phases of PHASES in order
    (the grid barriers), in each the (graph, tile) items in launch order,
    each walking the F planes. Returns (out, the scratch planes)."""
    _, f_n, h, w = y.shape
    g_n = n_graphs
    th, tw = tile
    hs, hsc, hxr, hxc = 3, 4, pu.K7_HALO, 4  # the f32 x box's 16-byte chunk: 4 columns
    geo = dict(th=th, tw=tw, hs=hs, hsc=hsc)
    if pg is None:
        pg = pl = identity_table(g_n, f_n)
    planes = {k: torch.full((1, g_n * f_n, h, w), float("nan")) for k in (*SCRATCH, "out")}
    for kind, xs, rhs_k, prev_k, o_k, u_k, a_col, b_col in PHASES:
        glr = kind.startswith("cg")
        for g in range(g_n):
            mu, ro, gam = scal[g, 0:1], scal[g, 1:2], scal[g, 2:3]
            for i0 in range(0, h, th):
                for j0 in range(0, w, tw):
                    i1, j1 = min(i0 + th, h), min(j0 + tw, w)
                    # the item's weight boxes, once for its F planes
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
                                             DIAMOND12)[0, :i1 - i0, :j1 - j0]
                        xv = xb[0, hxr:hxr + i1 - i0, hxc:hxc + j1 - j0]
                        sl = (0, ch, slice(i0, i1), slice(j0, j1))
                        if kind == "rhs":
                            o = xv + t
                        elif kind == "rethresh":
                            o = y[0, f, i0:i1, j0:j1] + t
                        elif kind == "cg_first":  # x is the rhs: u = -t
                            u = -t
                            planes[u_k][sl] = u
                            o = xv + scal[g, a_col] * u
                        else:
                            u = (planes[rhs_k][sl] - (xv + t)
                                 + scal[g, b_col] * planes[prev_k][sl])
                            o = xv + scal[g, a_col] * u
                        planes[o_k][sl] = o
    return planes["out"], {k: planes[k] for k in SCRATCH}


def _inputs(h, w, g, f, seed):
    """ỹ (1, F, h, w) U[0, 1); GTV and GLR softmax weights (1, G, 12, h, w);
    stencil tables near (1, ½, ½, ½); μ, ρ U(0.2, 0.3), γ U(0.02, 0.03),
    α ≈ 0.5, β ≈ 0.1 (the (G, 9) scal)."""
    rng = np.random.RandomState(seed)

    def soft():
        z = rng.randn(1, g, E, h, w)
        ex = np.exp(z - z.max(axis=2, keepdims=True))
        return (ex / ex.sum(axis=2, keepdims=True)).astype(np.float32)

    y = rng.rand(1, f, h, w).astype(np.float32)
    wg, wl = soft(), soft()
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    pg, pl = ((inits + 0.3 * rng.randn(g, 4, f)).astype(np.float32) for _ in range(2))
    coef = ((0.2 + 0.1 * rng.rand(g)).astype(np.float32), (0.2 + 0.1 * rng.rand(g)).astype(np.float32),
            (0.02 + 0.01 * rng.rand(g)).astype(np.float32),
            (0.5 + 0.1 * rng.randn(4, g)).astype(np.float32),
            (0.1 + 0.05 * rng.randn(4, g)).astype(np.float32))
    return y, wg, wl, pg, pl, coef


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("tile,hw,g,stats", [
    ((16, 64), (20, 36), 2, True), ((16, 64), (37, 53), 2, True), ((16, 64), (8, 12), 2, True),
    ((16, 64), (5, 130), 1, True), ((16, 64), (40, 70), 3, False), ((16, 64), (2, 3), 2, True),
    ((32, 64), (34, 70), 2, True), ((32, 64), (33, 129), 1, False)],
    ids=["16x64_two_tile_rows", "16x64_odd_ragged", "16x64_smaller_than_a_tile",
         "16x64_short_and_wide", "16x64_no_stats_G3", "16x64_2x3_smallest",
         "32x64_ragged", "32x64_no_stats_three_tile_columns"])
def test_phase_scheme_matches_plain(tile, hw, g, stats):
    """The six phases over ragged tiles on every image edge, a plane smaller
    than one tile, odd H and W, 16x64 (f32's plan) and 32x64 tiles (bf16's),
    with and without stencils: the output equals the plain unroll, every
    output pixel is written and no uncomputed or overwritten cell is read."""
    y, wg, wl, pg, pl, coef = _inputs(*hw, g, 3, seed=sum(hw) + tile[0])
    scal = pu.pixel_unroll_scal(g, *map(_t, coef))
    tabs = (_t(pg), _t(pl)) if stats else (None, None)
    out, scratch = phased_unroll(_t(y), _t(wg), _t(wl), *tabs, scal, g, tile=tile)
    want = pu.pixel_unroll_plain(_t(y), _t(wg), _t(wl), *tabs, scal, n_graphs=g)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)
    assert all(not torch.isnan(p).any() for p in scratch.values())


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "no_stats"])
def test_phase_scheme_matches_jax_kernel(stats):
    """The transliteration against JAX's Pallas kernel in interpret mode at
    the JAX tests' shape (16x128: two tile columns of the served 32x64
    tile, each cut to 16 rows), G = 4, F = 3."""
    g = 4
    y, wg, wl, pg, pl, coef = _inputs(16, 128, g, 3, seed=5 + stats)
    scal = np.asarray(jax_pixel_scal(g, *coef))
    tabs = (pg, pl) if stats else (None, None)
    ref = np.asarray(jax_pixel_unroll(
        jnp.asarray(y), jnp.asarray(wg), jnp.asarray(wl),
        *(None if t is None else jnp.asarray(t) for t in tabs), jnp.asarray(scal),
        n_graphs=g, deltas=DIAMOND12, interpret=True))
    out, _ = phased_unroll(_t(y), _t(wg), _t(wl), *map(_t, tabs), _t(scal), g)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - np.tile(y, (1, g, 1, 1))).max() > 0.05


@pytest.mark.parametrize("k", range(len(PHASES)))
def test_phase_never_writes_the_plane_it_reads_over_a_box(k):
    """Each phase writes only scratch planes it does not read over a box
    (its x), and reads every other plane at its own pixels only: the three
    planes are enough, with no barrier inside a phase. The planes a phase
    reads were written by an earlier phase and not overwritten since."""
    kind, xs, rhs_k, prev_k, o_k, u_k, _, _ = PHASES[k]
    written = {o_k, u_k} - {None}
    assert xs not in written
    assert written <= set(SCRATCH) | ({"out"} if k == len(PHASES) - 1 else set())
    last_writer = {}
    for j, (_, _, _, _, o, u, _, _) in enumerate(PHASES[:k]):
        for p in (o, u):
            if p is not None:
                last_writer[p] = j
    wants = {"rhs": ("y",), "cg_first": (xs,), "cg_next": (xs, rhs_k, prev_k),
             "rethresh": (xs, "y")}[kind]
    for p in wants:
        assert p == "y" or p in last_writer, (kind, p)
    # the CG steps read the rhs of their own round: rhs1 for phases 2-3,
    # rhs2 (the re-threshold's) for phases 5-6
    if kind == "cg_next":
        assert last_writer[rhs_k] == k - 2 and last_writer[prev_k] == k - 1


def test_scratch_is_three_f32_planes_per_channel_plane():
    """The wrapper allocates irdu_pixel_unroll_scratch_floats per channel
    plane: the kernel's three planes, written as PHASES names them."""
    assert {p for ph in PHASES for p in (ph[4], ph[5]) if p in SCRATCH} == set(SCRATCH)
    assert len(SCRATCH) == 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k7_smem_bytes_fit_the_card(dtype):
    """Each type's K7 tile (32x64 in bf16, 16x64 in f32) fits a CTA (227 KB)
    as many times an SM as K7_TILES names (228 KB, 1 KB reserved a CTA)."""
    smem = pu.k7_smem_bytes(dtype)
    assert smem <= 232448
    assert pu.K7_TILES[dtype][3] * (smem + 1024) <= 233472
    assert pu.K7_TILES[dtype][:2] == ((32, 64) if dtype == torch.bfloat16 else (16, 64))
