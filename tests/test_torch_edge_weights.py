"""K2 (edge weights) of the port against the JAX package's Pallas kernel,
run in interpret mode; the JAX side takes lane-padded features and a true
width below the padded one, the port the true width. Then the kernel's
scheme (bands of rows in shared memory with the replicate pad beside them,
several pixels a thread, features in chunks) in plain PyTorch against the
plain version and JAX, and its planner at every served shape."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_chw import edge_weights_chw as jax_edge_weights
from irdu_tpu_torch.ops import edge_weights as ew
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
from irdu_tpu_torch.ops.windows import CROSS4, DIAMOND12, RING8, WINDOWS
from irdu_tpu_torch.predict import _CONFIGS

# (B, n_graphs, F, H, W): 2G graphs as the solver batches GTV and GLR
SHAPES = [(1, 4, 3, 16, 96), (2, 6, 2, 8, 40), (1, 4, 6, 16, 128)]


def _inputs(b, g, f, h, w, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, g * f, h, w).astype(np.float32)
    multi_m = (1.0 + 0.3 * rng.randn(g, f)).astype(np.float32)
    return feats, multi_m


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_edge_weights_match_jax_kernel(shape):
    b, g, f, h, w = shape
    feats, multi_m = _inputs(*shape)
    wp = -(-w // 128) * 128
    padded = np.pad(feats, ((0, 0), (0, 0), (0, 0), (0, wp - w)))
    ref = np.asarray(jax_edge_weights(jnp.asarray(padded), jnp.asarray(multi_m),
                                      n_graphs=g, true_h=h, true_w=w,
                                      interpret=True))[..., :w]
    before = edge_weights_chw.launches
    out = edge_weights_chw(torch.from_numpy(feats), torch.from_numpy(multi_m),
                           n_graphs=g).numpy()
    assert edge_weights_chw.launches == before, "a CPU tensor must not launch"
    assert out.shape == (b, g, 4, h, w)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out.sum(axis=2), 1.0, atol=1e-5)


def test_edge_weights_keep_the_input_dtype():
    feats, multi_m = _inputs(1, 4, 3, 8, 12)
    x = torch.from_numpy(feats).bfloat16()
    out = edge_weights_plain(x, torch.from_numpy(multi_m), 4)
    assert out.dtype == torch.bfloat16
    ref = edge_weights_plain(x.float(), torch.from_numpy(multi_m), 4)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=4e-3)


@pytest.mark.parametrize("bad", ["channels", "multi_m", "rank"])
def test_edge_weights_reject_bad_shapes(bad):
    feats, multi_m = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 8, 12))
    if bad == "channels":
        feats = feats[:, :11]
    elif bad == "multi_m":
        multi_m = multi_m[:, :2]
    else:
        feats = feats[0]
    with pytest.raises(ValueError):
        edge_weights_chw(feats, multi_m, n_graphs=4)


# ---------------------------------------------------------------------------
# The kernel's band scheme and its planner
# ---------------------------------------------------------------------------

def _band_scheme(feats, multi_m, g, deltas, esize, plan=None):
    """The kernel's scheme (kernels/csrc/edge_weights.cu) in PyTorch, f32: per
    (batch, graph) and tile of bh rows by tx·(16 / esize) columns of the plan,
    shared memory of the tile plus ``radius`` rows (clamped to the image) and
    EDGE_PAD columns each side, of which only the image's columns and the
    2-column replicate pad beyond its edges are filled (the rest NaN, so that
    a read of them shows); features in chunks of fc, summing the squared
    norms of every position and each pixel's E metric-weighted dots; then
    1/max(|.|, 1e-12), the softmax over E, the tile's pixels written."""
    b, c, h, w = feats.shape
    f = c // g
    r = ew.window_radius(deltas)
    bh, tx, fc, _ = plan or ew.plan_edge_tiles(f, esize, r)
    bw, pad = tx * (16 // esize), ew.EDGE_PAD
    rows, cols = bh + 2 * r, bw + 2 * pad
    x, m2 = feats.float(), multi_m.float() ** 2
    out = torch.full((b, g, len(deltas), h, w), float("nan"))
    for bb in range(b):
        for gg in range(g):
            planes = x[bb, gg * f:(gg + 1) * f]
            for i0 in range(0, h, bh):
                for j0 in range(0, w, bw):
                    grow = (i0 - r + torch.arange(rows)).clamp(0, h - 1)
                    gcol = j0 - pad + torch.arange(cols)
                    filled = (gcol >= -2) & (gcol < w + 2)
                    band = torch.full((f, rows, cols), float("nan"))
                    band[:, :, filled] = planes[:, grow][:, :, gcol[filled].clamp(0, w - 1)]
                    nsq = torch.zeros(rows, cols)
                    dots = torch.zeros(len(deltas), bh, bw)
                    for f0 in range(0, f, fc):
                        chunk = band[f0:f0 + fc]
                        nsq = nsq + (chunk * chunk).sum(0)
                        ctr = chunk[:, r:r + bh, pad:pad + bw] * m2[gg, f0:f0 + fc, None, None]
                        for e, (dh, dw) in enumerate(deltas):
                            nb = chunk[:, r + dh:r + dh + bh, pad + dw:pad + dw + bw]
                            dots[e] = dots[e] + (ctr * nb).sum(0)
                    inv = 1 / torch.sqrt(nsq).clamp(min=1e-12)
                    sims = dots * inv[r:r + bh, pad:pad + bw] * torch.stack(
                        [inv[r + dh:r + dh + bh, pad + dw:pad + dw + bw] for dh, dw in deltas])
                    vh, vw = min(bh, h - i0), min(bw, w - j0)
                    out[bb, gg, :, i0:i0 + vh, j0:j0 + vw] = torch.softmax(sims, 0)[:, :vh, :vw]
    assert bool(torch.isfinite(out).all())  # every pixel written, no unfilled column read
    return out


# (B, graphs, F, H, W, window, element size): a vector-aligned width and
# odd widths (element copies, ragged last tiles), H a multiple of 8 for JAX
BAND_CASES = [(1, 4, 3, 16, 40, "cross4", 2), (2, 6, 5, 16, 37, "diamond12", 2),
              (1, 4, 12, 24, 30, "cross4", 4), (1, 3, 7, 8, 21, "diamond12", 4),
              (1, 5, 12, 16, 40, "ring8", 2), (1, 2, 9, 8, 27, "ring8", 4)]


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: "{}x{}x{}_{}x{}_{}_e{}".format(*c))
def test_band_scheme_matches_plain_and_jax(case):
    """Every window, ragged H and W, F from 3 to 12, the bf16 and f32 plans:
    within 1e-5 of the plain version (the same f32 function, summed in
    another order) and JAX's kernel's bar (5e-4, 1e-3)."""
    b, g, f, h, w, win, esize = case
    deltas = WINDOWS[win]
    feats, multi_m = _inputs(b, g, f, h, w, seed=f)
    ft, mt = torch.from_numpy(feats), torch.from_numpy(multi_m)
    out = _band_scheme(ft, mt, g, deltas, esize)
    np.testing.assert_allclose(out.numpy(), edge_weights_plain(ft, mt, g, deltas).numpy(),
                               atol=1e-5, rtol=1e-5)
    wp = -(-w // 128) * 128
    padded = np.pad(feats, ((0, 0), (0, 0), (0, 0), (0, wp - w)))
    ref = np.asarray(jax_edge_weights(jnp.asarray(padded), jnp.asarray(multi_m), n_graphs=g,
                                      true_h=h, true_w=w, deltas=deltas,
                                      interpret=True))[..., :w]
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("win", ["cross4", "diamond12", "ring8"])
def test_band_scheme_in_feature_chunks(win):
    """F = 8 in chunks of 3, 3, 2 (the plan the ablations' F = 96 takes, at a
    small size), 8-row bands of 4 threads a row: equal to the plain version."""
    deltas = WINDOWS[win]
    feats, multi_m = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 19, 45, seed=3))
    out = _band_scheme(feats, multi_m, 2, deltas, 2, plan=(8, 4, 3, None))
    torch.testing.assert_close(out, edge_weights_plain(feats, multi_m, 2, deltas),
                               atol=1e-5, rtol=1e-5)


def _served_edge_calls():
    """(B, graphs, F, H, W, radius) of the K2 calls the family serves: each
    model's two calls a scale (the full- and half-resolution features of 2G
    graphs) at its request sizes; the pixel model's 2G = 48 graphs of 3
    features on diamond-12; the ablations' one-graph heads (2 graphs of 96
    features); GLR boosting's four levels on ring-8 (5 graphs of 12, 12, 24
    and 48 features at full, half, quarter and eighth resolution)."""
    calls = set()
    sizes = ((512, 512), (480, 320), (256, 384), (1024, 1024), (2048, 2048))
    for name in ("flagship", "lite", "micro"):
        cfg = _CONFIGS[name]()
        for h, w in sizes:
            for s, (c, g) in enumerate(zip(cfg["dims"], cfg["ngraphs"])):
                for res in (s, s + 1):
                    calls.add((1, 2 * g, c // g, h >> res, w >> res, 1))
    for h, w in ((512, 512), (480, 320), (1024, 1024), (2048, 2048)):
        calls.add((1, 48, 3, h, w, 2))
    calls |= {(1, 2, 96, 512, 512, 1), (1, 2, 96, 256, 256, 1)}
    for h, w in sizes:
        for k, f in enumerate((12, 12, 24, 48)):
            calls.add((1, 5, f, h >> k, w >> k, 1))
    return sorted(calls)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_edge_plan_fits_every_served_call(esize):
    """At every served K2 call the plan is the swept band (EDGE_ROWS rows of
    EDGE_TX threads) within the kernel's 256 threads, keeps to EDGE_SMEM (its
    layout's bytes) and takes at least one feature a chunk, all of them
    where they fit; the ablations' 96 features take chunks in bf16."""
    for b, g, f, h, w, r in _served_edge_calls():
        bh, tx, fc, smem = ew.plan_edge_tiles(f, esize, r)
        assert (bh, tx) == (ew.EDGE_ROWS, ew.EDGE_TX) and bh * tx <= 256
        assert smem == ew.edge_smem_bytes(esize, fc, f, bh, tx, r) <= ew.EDGE_SMEM
        assert 1 <= fc <= f and (fc == f or ew.edge_smem_bytes(esize, fc + 1, f, bh, tx, r)
                                 > ew.EDGE_SMEM), (g, f, h, w)
    assert ew.plan_edge_tiles(96, 2, 1)[2] < 96


def test_edge_smem_layout_bytes():
    """The kernel's shared memory counted by hand at the flagship's 512x512
    scale-0 call (16 graphs of 6 features, bf16): 16-row bands of 8 threads
    a row, 8 pixels each: 6 planes of 18 rows x 80 columns in bf16, the f32
    squared norms of those positions, 6 squared metric entries."""
    want = 6 * 18 * 80 * 2 + 18 * 80 * 4 + 6 * 4
    assert ew.plan_edge_tiles(6, 2, 1) == (16, 8, 6, want) == (16, 8, 6, 23064)


def test_window_radius():
    assert ew.window_radius(CROSS4) == 1 and ew.window_radius(DIAMOND12) == 2
    assert ew.window_radius(RING8) == 1
    assert {len(d): d for d in WINDOWS.values()} == ew.KERNEL_WINDOWS
