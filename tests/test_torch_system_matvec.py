"""K9 (``irdu_tpu_torch/ops/system_matvec.py``) of the port against the JAX
package's ``fused_system_matvec`` in interpret mode, against the port's K6a
on the same data in CHW, and the CUDA kernel's tiling scheme (8x16 tiles
with a 4-pixel halo, channels-last, derived planes read through a clamp to
the region, zeros outside the image by global index) run in PyTorch against
the plain version. Tolerances: JAX's own ``atol=1e-4, rtol=1e-4`` for its
kernel (tests/test_pallas_kernels.py), 1e-5 between the port's own f32
formulations."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.graph import extract_edge_weights
from irdu_tpu.ops.pallas.solver_matvec import fused_system_matvec as jax_matvec
from irdu_tpu.ops.windows import EDGE_DELTAS_CROSS4
from irdu_tpu_torch.ops import system_matvec as sm
from irdu_tpu_torch.ops.fused_step import matvec_plain
from irdu_tpu_torch.ops.windows import CROSS4


def _inputs(seed, b=2, h=32, w=16, g=2, f=4):
    """x (B, H, W, C); the GLR and GTV softmax weights (B, H, W, G, 4) from
    JAX's extract_edge_weights; stencil rows (4, C); μ, ρ per channel."""
    rng = np.random.RandomState(seed)
    c = g * f
    x = rng.randn(b, h, w, c).astype(np.float32)
    feats = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32))
    mm = jnp.asarray(rng.rand(g, f).astype(np.float32) + 0.5)
    wglr = np.array(extract_edge_weights(feats, mm, EDGE_DELTAS_CROSS4, g)[0])
    wgtv = np.array(extract_edge_weights(feats * 1.3 + 0.1, mm, EDGE_DELTAS_CROSS4, g)[0])
    rows = [rng.randn(4, c).astype(np.float32) for _ in range(2)]
    mu = np.repeat(np.abs(rng.randn(g)), f).astype(np.float32)
    ro = np.repeat(np.abs(rng.randn(g)), f).astype(np.float32)
    return [x, wglr, wgtv, rows[0], rows[1], mu, ro]


@pytest.mark.parametrize("h,tile_h", [(32, 8), (20, 4)], ids=["h32", "h20_not_mult_of_8"])
def test_matches_jax_kernel(h, tile_h):
    """The wrapper on CPU tensors (its plain version; no launch) against JAX's
    Pallas kernel in interpret mode, at the JAX test's shape and at H = 20."""
    args = _inputs(seed=h, h=h)
    ref = jax_matvec(*(jnp.asarray(a) for a in args), n_graphs=2, tile_h=tile_h,
                     interpret=True)
    before = sm.fused_system_matvec.launches
    out = sm.fused_system_matvec(*(torch.from_numpy(a) for a in args), n_graphs=2)
    assert sm.fused_system_matvec.launches == before, "a CPU tensor must not launch"
    assert out.shape == args[0].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert np.abs(np.asarray(ref) - args[0]).max() > 0.1


def test_matches_k6a_on_chw():
    """K9 and K6a compute the same function: the same data permuted to CHW,
    the rows as (G, 4, F) tables, μ and ρ per graph."""
    g, f = 2, 4
    x, wglr, wgtv, pl, pg, mu, ro = (torch.from_numpy(a) for a in _inputs(seed=3, g=g, f=f))
    out = sm.system_matvec_plain(x, wglr, wgtv, pl, pg, mu, ro, n_graphs=g)

    def table(rows):
        return rows.reshape(4, g, f).permute(1, 0, 2)

    chw = matvec_plain(x.permute(0, 3, 1, 2), wglr.permute(0, 3, 4, 1, 2),
                       wgtv.permute(0, 3, 4, 1, 2), table(pl), table(pg), mu[::f], ro[::f],
                       n_graphs=g)
    torch.testing.assert_close(out, chw.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-5)


def test_identity_rows_equal_no_stats():
    """Rows (1, 0, 0, 0), which the kernel takes for a stencil set to None,
    give the no-stats operator exactly."""
    x, wglr, wgtv, _, _, mu, ro = (torch.from_numpy(a) for a in _inputs(seed=4))
    c = x.shape[-1]
    eye = sm.identity_rows(c)
    a = sm.system_matvec_plain(x, wglr, wgtv, eye, eye, mu, ro, n_graphs=2)
    b = sm.fused_system_matvec(x, wglr, wgtv, None, None, mu, ro, n_graphs=2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["rank", "graphs", "weights", "rows", "scales"])
def test_rejects_wrong_shapes(what):
    args = [torch.from_numpy(a) for a in _inputs(seed=5, b=1, h=8, w=8)]
    g = 2
    if what == "rank":
        args[0] = args[0][0]
    elif what == "graphs":
        g = 3
    elif what == "weights":
        args[1] = args[1][..., :3]
    elif what == "rows":
        args[3] = args[3][:3]
    else:
        args[5] = args[5][:-1]
    with pytest.raises(ValueError):
        sm.fused_system_matvec(*args, n_graphs=g)


# ---------------------------------------------------------------------------
# the CUDA kernel's scheme (kernels/csrc/system_matvec.cu), transliterated
# ---------------------------------------------------------------------------

HALO = 4


def _tiled(x, wglr, wgtv, pl, pg, mu, ro, g, th, tw):
    """K9 tile by tile as the kernel computes it, f32, batch 1: every stage
    over the tile's region (the tile plus HALO pixels, clipped to the image),
    reads clamped to the region, the scatter and statsᵀ zero outside the
    image."""
    _, h, w, c = x.shape
    f = c // g
    graph_of = torch.arange(c) // f
    out = torch.empty_like(x)
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            i1, j1 = min(i0 + th, h), min(j0 + tw, w)
            r0, r1, c0, c1 = max(i0 - HALO, 0), min(i1 + HALO, h), max(j0 - HALO, 0), min(j1 + HALO, w)
            gi, gj = torch.meshgrid(torch.arange(r0, r1), torch.arange(c0, c1), indexing="ij")

            def at(a, i, j):  # (rows, cols, C) region plane at (i, j) clamped
                return a[i.clamp(r0, r1 - 1) - r0, j.clamp(c0, c1 - 1) - c0]

            def inside(i, j):
                return ((i >= 0) & (i < h) & (j >= 0) & (j < w))[..., None]

            def wt(wa, e, i, j):  # the channel's graph's weight of edge e at (i, j)
                return wa[0, i.clamp(0, h - 1), j.clamp(0, w - 1)][..., graph_of, e]

            def stats(a, p):
                v, r, d = at(a, gi, gj), at(a, gi, gj + 1), at(a, gi + 1, gj)
                u, l = at(a, gi - 1, gj), at(a, gi, gj - 1)
                return p[0] * v + p[1] * (r - v) + p[2] * (d - v) + p[3] * (4 * v - u - d - l - r)

            def stats_t(a, p, i, j):
                def z(di, dj):
                    return torch.where(inside(i + di, j + dj), at(a, i + di, j + dj), 0.0)

                v, r_, d_, u_, l_ = at(a, i, j), z(0, 1), z(1, 0), z(-1, 0), z(0, -1)
                return p[0] * v + p[1] * (l_ - v) + p[2] * (u_ - v) + p[3] * (4 * v - u_ - d_ - l_ - r_)

            xr = x[0, r0:r1, c0:c1]
            sg, sl = stats(xr, pg), stats(xr, pl)
            ag, al = 0.0, at(sl, gi, gj)
            for e, (dh, dw) in enumerate(CROSS4):
                we = wt(wgtv, e, gi, gj)
                ag = ag + we * we * (at(sg, gi, gj) - at(sg, gi + dh, gj + dw))
                qi, qj = gi - dh, gj - dw
                wq = wt(wgtv, e, qi, qj)
                nbr = wq * wq * (at(sg, qi, qj) - at(sg, gi, gj))
                ag = ag - torch.where(inside(qi, qj), nbr, 0.0)
                al = al - wt(wglr, e, gi, gj) * at(sl, gi + dh, gj + dw)
            ti, tj = torch.meshgrid(torch.arange(i0, i1), torch.arange(j0, j1), indexing="ij")
            out[0, i0:i1, j0:j1] = (x[0, i0:i1, j0:j1] + ro * stats_t(ag, pg, ti, tj)
                                    + mu * stats_t(al, pl, ti, tj))
    return out


@pytest.mark.parametrize("th,tw", [(8, 16), (5, 7)], ids=["8x16", "5x7_ragged"])
def test_kernel_tiling_scheme_matches_plain(th, tw):
    """20x28 plane, 2 graphs of 4 channels: tiles on every image edge,
    interior tiles and ragged last tiles give the plain version."""
    x, wglr, wgtv, pl, pg, mu, ro = (torch.from_numpy(a) for a in
                                     _inputs(seed=6, b=1, h=20, w=28))
    out = _tiled(x, wglr, wgtv, pl, pg, mu, ro, 2, th, tw)
    want = sm.system_matvec_plain(x, wglr, wgtv, pl, pg, mu, ro, n_graphs=2)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
