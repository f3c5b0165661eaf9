"""K9 (``irdu_tpu_torch/ops/system_matvec.py``) of the port against the JAX
package's ``fused_system_matvec`` in interpret mode, against the port's K6a
on the same data in CHW, and the CUDA kernel's scheme (the padded tile on
the cross-4 window, channels-last chunks of 8 lanes walked graph by graph,
the graph's weights staged once a tile) run in PyTorch against the plain
version and JAX. Tolerances: JAX's own ``atol=1e-4, rtol=1e-4`` for its
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
from test_torch_fused_step import box_at, pad_box, padded_tile_term, zero_box


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
# the CUDA kernel's scheme (kernels/csrc/system_matvec.cu), transliterated:
# per output tile, graph by graph, the graph's weight boxes once (zero
# outside the image), then each chunk of up to 8 channels (never across two
# graphs) through the padded tile of tests/test_torch_fused_step.py on the
# cross-4 window: x on the tile + 3 with the replicate pad, S and the
# weights on the tile + 2, the edge sums on the tile + 1, stage planes over
# boxes not clipped to the image and read by unclamped offsets
# ---------------------------------------------------------------------------


def lane_tiled(x, wglr, wgtv, pl, pg, mu, ro, g, th, tw, lanes=8):
    """K9 as the kernel computes it, f32, batch 1: the tiles in launch order,
    in each the graphs in turn, in each its chunks of ``lanes`` channels
    (the last one partial where F is not a multiple); rows None are the
    identity stencil. Cells the kernel leaves unwritten stay NaN."""
    _, h, w, c = x.shape
    f = c // g
    hs, hx = 2, sm.K9_HALO
    geo = dict(th=th, tw=tw, hs=hs, hsc=hs)
    pl = sm.identity_rows(c) if pl is None else pl
    pg = sm.identity_rows(c) if pg is None else pg
    xc = x[0].permute(2, 0, 1)  # (C, H, W)
    wgv, wlv = (wt[0].permute(2, 3, 0, 1) for wt in (wgtv, wglr))  # (G, 4, H, W)
    out = torch.full_like(x, float("nan"))
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            i1, j1 = min(i0 + th, h), min(j0 + tw, w)
            for gi in range(g):
                wgb, wlb = (zero_box(wv[gi], i0 - hs, j0 - hs, th + 2 * hs, tw + 2 * hs)
                            for wv in (wgv, wlv))
                for k0 in range(0, f, lanes):
                    chs = list(range(gi * f + k0, gi * f + min(k0 + lanes, f)))
                    n = len(chs)
                    xb = pad_box(xc[chs], i0 - hx, j0 - hx, th + 2 * hx, tw + 2 * hx, False)

                    def taps(di, dj, rows, cols, xb=xb):
                        ci = (i0 - hs + rows).clamp(0, h - 1) - (i0 - hx)
                        cj = (j0 - hs + cols).clamp(0, w - 1) - (j0 - hx)
                        return box_at(xb, ci + di, cj + dj)

                    t = padded_tile_term(geo, taps, wgb.expand(n, -1, -1, -1),
                                         wlb.expand(n, -1, -1, -1), pg[:, chs].T, pl[:, chs].T,
                                         ro[chs], mu[chs], None, i0, j0, h, w, CROSS4)
                    xv = xb[:, hx:hx + i1 - i0, hx:hx + j1 - j0]
                    out[0, i0:i1, j0:j1, chs] = (xv + t[:, :i1 - i0, :j1 - j0]).permute(1, 2, 0)
    return out


@pytest.mark.parametrize("th,tw", [(8, 16), (5, 7)], ids=["8x16", "5x7_ragged"])
def test_kernel_tiling_scheme_matches_plain(th, tw):
    """20x28 plane, 2 graphs of 4 channels (one partial chunk each): tiles on
    every image edge, interior tiles and ragged last tiles give the plain
    version, and no cell the scheme leaves uncomputed is read."""
    x, wglr, wgtv, pl, pg, mu, ro = (torch.from_numpy(a) for a in
                                     _inputs(seed=6, b=1, h=20, w=28))
    out = lane_tiled(x, wglr, wgtv, pl, pg, mu, ro, 2, th, tw)
    want = sm.system_matvec_plain(x, wglr, wgtv, pl, pg, mu, ro, n_graphs=2)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tile,hw,g,f,rows", [
    ((8, 32), (20, 70), 1, 24, True), ((16, 32), (37, 53), 2, 20, True),
    ((16, 16), (9, 17), 3, 5, True), ((8, 32), (17, 33), 2, 16, False),
    ((16, 32), (40, 36), 1, 8, True)],
    ids=["8x32_G1_whole_chunks", "16x32_G2_F20_partial_chunks", "16x16_F5_below_a_chunk",
         "8x32_identity_rows", "16x32_one_chunk_three_tile_rows"])
def test_lane_tiles_match_plain(tile, hw, g, f, rows):
    """K9's scheme on the swept tiles (8 lanes) over odd H and W, G = 1
    (every chunk shares the weights), F not a multiple of the lanes (the
    last chunk of each graph partial: K9_RAGGED's F = 20), F below one
    chunk, and the None rows of the no-stats ablations: the transliteration
    equals the plain version within JAX's tolerance for this kernel (the
    per-lane sums run in another order than the plain version's)."""
    th, tw = tile
    lanes = sm.K9_TILE[2]
    x, wglr, wgtv, pl, pg, mu, ro = (torch.from_numpy(a) for a in
                                     _inputs(seed=70 + th + tw, b=1, h=hw[0], w=hw[1], g=g, f=f))
    if not rows:
        pl = pg = None
    out = lane_tiled(x, wglr, wgtv, pl, pg, mu, ro, g, th, tw, lanes)
    want = sm.system_matvec_plain(x, wglr, wgtv, pl, pg, mu, ro, n_graphs=g)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("g,f", [(1, 16), (2, 12)], ids=["G1", "G2_partial_chunks"])
def test_lane_tiles_match_jax_kernel(g, f):
    """The served tile's transliteration against JAX's Pallas kernel in
    interpret mode at the JAX test's shape (32x16: two tile rows of the
    served 16x16 tile)."""
    args = _inputs(seed=80 + g, b=1, g=g, f=f)
    ref = jax_matvec(*(jnp.asarray(a) for a in args), n_graphs=g, tile_h=8, interpret=True)
    th, tw, lanes, _, _ = sm.K9_TILE
    out = lane_tiled(*(torch.from_numpy(a) for a in args), g, th, tw, lanes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k9_smem_bytes_fit_the_card(dtype):
    """K9's tile fits a CTA (227 KB) as many times an SM as K9_TILE names
    (228 KB, 1 KB reserved a CTA), in bf16 and f32."""
    smem = sm.k9_smem_bytes(dtype)
    assert smem <= 232448
    assert sm.K9_TILE[4] * (smem + 1024) <= 233472