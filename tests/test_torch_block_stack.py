"""K3 (up to four stacked LocalNonLinearBlocks) of the port against the JAX
package's Pallas kernel in interpret mode, the stacked operands of the 86k
snapshot against the JAX package's, block_stack.cu's tiling scheme (each
tile with a K-pixel halo, taps clamped to the tile's region) and the wgmma
stack kernel's phase scheme (a 1-pixel halo per block, the f32 activation
in ping-pong scratch between blocks) run in plain PyTorch against the
block-by-block plain version and JAX, and the wgmma kernel's planner,
shared memory and route by shape."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.ops.pallas.block_stack import fused_block_stack as jax_block_stack
from irdu_tpu.ops.pallas.block_stack import pack_block_params as jax_pack
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.models.flagship import STACK_MAX_BLOCKS, STACK_MAX_DIM
from irdu_tpu_torch.ops import block_stack as bs
from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.ops.block_stack import block_stack_plain, fused_block_stack, pack_block_params
from irdu_tpu_torch.ops.gated_block import block_f32, gated_block_plain
from irdu_tpu_torch.predict import _CONFIGS, DEFAULT_WEIGHTS, load_model


def _mk_params(rng, c, h2, k):
    return [dict(scale=rng.randn(c).astype(np.float32) * 0.1 + 1.0,
                 w1=(rng.randn(c, h2) / np.sqrt(c)).astype(np.float32),
                 dwk=(rng.randn(3, 3, h2) * 0.2).astype(np.float32),
                 w2=(rng.randn(h2 // 2, c) / np.sqrt(h2 // 2)).astype(np.float32),
                 skip=np.array([1.0, 0.8], np.float32)) for _ in range(k)]


def _torch_params(params):
    return [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]


# the JAX package's own block-stack shapes (tests/test_block_stack.py)
@pytest.mark.parametrize("c,h2,h,w,k", [
    (48, 192, 32, 128, 4),   # stacked: image-boundary rebuild exercised
    (16, 64, 24, 256, 3),
    (48, 192, 16, 128, 1),   # single block
    (8, 32, 8, 128, 2),      # single band
])
def test_block_stack_matches_jax_kernel(c, h2, h, w, k):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, c, h, w) * 0.5).astype(np.float32)
    params = _mk_params(rng, c, h2, k)
    ref = np.asarray(jax_block_stack(jnp.asarray(x), *jax_pack(params, jnp.float32),
                                     interpret=True))
    launches = fused_block_stack.launches
    out = fused_block_stack(torch.from_numpy(x),
                            *pack_block_params(_torch_params(params), torch.float32))
    assert fused_block_stack.launches == launches
    rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert rel < 2e-5, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stack_of_one_is_the_gated_block(dtype):
    """K = 1 of K3 and K4 compute the same function, rounding at the same
    points in bf16."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 16, 8, 12).astype(np.float32)).to(dtype)
    p = _torch_params(_mk_params(rng, 16, 48, 1))[0]
    p_cast = {**p, "w1": p["w1"].to(dtype), "w2": p["w2"].to(dtype)}
    torch.testing.assert_close(block_stack_plain(x, *pack_block_params([p], dtype)),
                               gated_block_plain(x, **p_cast), atol=0, rtol=0)


def test_block_stack_bf16_carries_f32_between_blocks():
    """In bf16 the stack rounds its activation once, at the end: two stacked
    blocks differ from two bf16 single-block calls."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 16, 8, 8).astype(np.float32)).bfloat16()
    ps = _torch_params(_mk_params(rng, 16, 48, 2))
    stacked = block_stack_plain(x, *pack_block_params(ps, torch.bfloat16))
    want = x.float()
    for p in ps:
        want = block_f32(want, p["scale"], p["w1"], p["dwk"], p["w2"], p["skip"], torch.bfloat16)
    torch.testing.assert_close(stacked, want.bfloat16(), atol=0, rtol=0)
    chained = x
    for p in ps:
        chained = gated_block_plain(chained, **{**p, "w1": p["w1"].bfloat16(),
                                                "w2": p["w2"].bfloat16()})
    assert not torch.equal(stacked, chained)


def _tiled(x, params, th, tw):
    """The block kernel's scheme in plain PyTorch: every output tile runs the
    K blocks on its region (the tile plus K pixels, clipped to the image);
    each block's replicate pad is a clamp to the region's bounds."""
    b, c, h, w = x.shape
    k = len(params)
    out = torch.empty_like(x)
    for ti in range(0, h, th):
        for tj in range(0, w, tw):
            r0, r1 = max(ti - k, 0), min(ti + th + k, h)
            c0, c1 = max(tj - k, 0), min(tj + tw + k, w)
            xr = x[:, :, r0:r1, c0:c1]
            for p in params:
                xr = block_f32(xr, p["scale"], p["w1"], p["dwk"], p["w2"], p["skip"],
                               torch.float32)
            out[:, :, ti:ti + th, tj:tj + tw] = xr[:, :, ti - r0:ti - r0 + th,
                                                   tj - c0:tj - c0 + tw]
    return out


@pytest.mark.parametrize("k,th,tw,h,w", [(4, 4, 4, 12, 20), (4, 8, 16, 16, 40),
                                         (1, 2, 4, 6, 10), (3, 3, 5, 11, 13)])
def test_tiled_scheme_matches_block_by_block(k, th, tw, h, w):
    """Tiles at all four image edges, interior tiles, ragged last tiles; the
    result equals the blocks run one by one over the whole image."""
    rng = np.random.RandomState(k * 100 + h)
    x = torch.from_numpy(rng.randn(1, 8, h, w).astype(np.float32))
    params = _torch_params(_mk_params(rng, 8, 24, k))
    want = block_stack_plain(x, *pack_block_params(params, torch.float32))
    torch.testing.assert_close(_tiled(x, params, th, tw), want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_pack_block_params_of_snapshot_equal_jax(dtype):
    """The stacked operands of the snapshot's four scale-0 encoder blocks."""
    jax_model = jax_flagship.AbstractMultiScaleGraphFilter(**jax_flagship.flagship_config())
    bound = jax_model.bind(jax_load(DEFAULT_WEIGHTS["flagship"], dtype=jnp.float32))
    want = jax_pack([blk.gated_params() for blk in bound.encoder_scales[0]], dtype)
    model = load_model(device="cpu")
    got = pack_block_params([blk.gated_params() for blk in model.encoder_scales[0]],
                            torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    for name, g, wnt in zip(("scales", "w1t", "dwk", "w2t", "skips"), got, want):
        assert tuple(g.shape) == wnt.shape, name
        np.testing.assert_array_equal(g.detach().float().numpy(),
                                      np.asarray(wnt, np.float32), err_msg=name)


# ---------------------------------------------------------------------------
# The wgmma stack kernel (kernels/csrc/block_stack_wgmma.cu): its phase plan,
# its planner and shared memory, and the route by shape
# ---------------------------------------------------------------------------

def _phase_scheme(x, params, dtype, th, tw, hc=32):
    """The wgmma stack kernel's scheme in PyTorch on an f32 x (already in
    ``dtype``): K phases, one block each. Phase k reads its input (x, then
    the f32 channels-last scratch S[(k - 1) mod 2]) over every th x tw tile plus a
    1-pixel halo clipped to the image: two-pass norm rounded to ``dtype``;
    per chunk of hc m- and hc u-channels the expand over the region, the taps
    read through a clamp to the region, the gate rounded to ``dtype``, the
    project added to one f32 accumulator; s0 x + s1 acc into S[k mod 2]
    (f32, (B, H, W, C)), or, in the last phase, the output rounded to
    ``dtype``."""
    b, c, h, w = x.shape
    k_blocks = len(params)
    scratch = [torch.full((b, h, w, c), float("nan")) for _ in range(bs.stack_scratch_planes(k_blocks))]
    src = x
    for k, p in enumerate(params):
        hidden = p["w2"].shape[0]
        w1, w2 = p["w1"].to(dtype).float(), p["w2"].to(dtype).float()
        dw, sk, scale = p["dwk"].float().reshape(9, -1), p["skip"].float(), p["scale"].float()
        # a channels-last buffer seen as (B, C, H, W)
        dst = torch.empty_like(x) if k == k_blocks - 1 else scratch[k % 2].permute(0, 3, 1, 2)
        for i0 in range(0, h, th):
            for j0 in range(0, w, tw):
                i1, j1 = min(i0 + th, h), min(j0 + tw, w)
                r0, r1, c0, c1 = max(i0 - 1, 0), min(i1 + 1, h), max(j0 - 1, 0), min(j1 + 1, w)
                assert (r1 - r0) * (c1 - c0) <= bs.STACK_MR and th * tw <= bs.STACK_MP
                xr = src[:, :, r0:r1, c0:c1]
                mean = xr.mean(1, keepdim=True)
                var = ((xr - mean) ** 2).sum(1, keepdim=True) / (c - 1)
                y0 = gb._round(xr * (1 / torch.sqrt(var + gb.EPS)) * scale[None, :, None, None],
                               dtype)
                ii = (torch.arange(i0, i1) - r0)[:, None]
                jj = (torch.arange(j0, j1) - c0)[None, :]
                acc = torch.zeros(b, c, i1 - i0, j1 - j0)
                for h0 in range(0, hidden, hc):
                    idx = list(range(h0, h0 + hc)) + list(range(hidden + h0, hidden + h0 + hc))
                    y1 = torch.einsum("bcij,co->boij", y0, w1[:, idx])
                    t = sum(y1[:, :, (ii + a - 1).clamp(0, r1 - r0 - 1),
                               (jj + bb - 1).clamp(0, c1 - c0 - 1)]
                            * dw[3 * a + bb, idx][None, :, None, None]
                            for a in range(3) for bb in range(3))
                    m, u = t[:, :hc], t[:, hc:]
                    y3 = gb._round(torch.sigmoid(m) * m * u, dtype)
                    acc = acc + torch.einsum("bhij,hc->bcij", y3, w2[h0:h0 + hc])
                dst[:, :, i0:i1, j0:j1] = sk[0] * src[:, :, i0:i1, j0:j1] + sk[1] * acc
        src = dst
    assert all(not torch.isnan(s).any() for s in scratch)  # every tile wrote its pixels
    return gb._round(src, dtype)


def _bf16_bar(out, want, exact):
    """block_bar of chip_smoke.py: at most 1 % of the outputs beyond one bf16
    ulp (4e-3 + 2^-7 |want|), none beyond one ulp plus want's own rounding
    error against the unrounded f32 function."""
    d = (out - want).abs()
    ulp = 4e-3 + 2.0 ** -7 * want.abs()
    own = float((want - exact).abs().max())
    return float((d > ulp).float().mean()) <= 0.01 and bool((d <= ulp + own).all())


# (K, C, hidden, H, W, tile_h, tile_w); H a multiple of 8 and W = 128 for
# JAX's kernel (its sublane and lane rules), ragged tiles in one or both
# directions
PHASE_CASES = [(4, 48, 96, 24, 128, 8, 12), (3, 16, 32, 16, 128, 5, 7),
               (2, 24, 64, 16, 128, 8, 16), (1, 48, 96, 8, 128, 6, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PHASE_CASES, ids=lambda c: "k{}_c{}_h{}_{}x{}".format(*c[:3], *c[5:]))
def test_stack_phase_scheme_matches_plain_and_jax(case, dtype):
    """K phases of 1-pixel-halo tiles with the f32 activation carried between
    them in the ping-pong scratch, rounded once at the end, equal the K
    blocks run one by one (the plain version) and JAX's Pallas kernel in
    interpret mode: f32 within 2e-5 (the sums run in other orders); bf16 to
    block_bar, against the plain version and JAX (y0 and y3 round at the same
    points, a value next to a rounding boundary may round the other way)."""
    k, c, hidden, h, w, th, tw = case
    rng = np.random.RandomState(k * 10 + c)
    xn = (rng.randn(1, c, h, w) * 0.7).astype(np.float32)
    params = _mk_params(rng, c, 2 * hidden, k)
    tp = _torch_params(params)
    x = torch.from_numpy(xn).to(dtype)
    out = _phase_scheme(x.float(), tp, dtype, th, tw).float()
    packed = pack_block_params(tp, dtype)
    plain = block_stack_plain(x, *packed).float()
    exact = block_stack_plain(x.float(), *pack_block_params(tp, torch.float32)).float()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_block_stack(jnp.asarray(x.float().numpy()).astype(jdt), *jax_pack(params, jdt),
                          interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert (plain - x.float()).abs().max() > 0.5  # the blocks moved their input
    for want in (plain, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)
        else:
            assert _bf16_bar(out, want, exact)


def _served_stack_calls():
    """(model, C, hidden, H, W, K) of every K3 call the family serves: the
    flagship (and ablation_no_mixture) at the five request sizes, lite and
    micro at 512², the split ablation heads at 512²."""
    calls = set()
    for name in ("flagship", "lite", "micro"):
        cfg = _CONFIGS[name]()
        sizes = ((512, 512), (480, 320), (256, 384), (1024, 1024), (2048, 2048)) \
            if name == "flagship" else ((512, 512),)
        for h, w in sizes:
            for s, (c, hd, n) in enumerate(zip(cfg["dims"], cfg["hidden_dims"], cfg["num_blocks"])):
                if c > STACK_MAX_DIM:
                    continue
                lists = [n, n] + ([cfg["num_blocks_out"]] if s == 0 else [])
                for n_list in lists:
                    for k0 in range(0, n_list, STACK_MAX_BLOCKS):
                        calls.add((name, c, hd, h >> s, w >> s, min(STACK_MAX_BLOCKS, n_list - k0)))
    calls.add(("split_heads", 48, int(48 * 8 / 3), 512, 512, 3))
    return sorted(calls)


def test_stack_route_at_every_served_shape():
    """bf16 K3 runs on the wgmma stack kernel at every served shape but
    lite's scale 0 (C = 24, H = 48: neither C nor H is one it is built for),
    which stays on block_stack.cu; f32 (the model check) stays there too."""
    calls = _served_stack_calls()
    routes = {(m, c, hd): bs.stack_route(torch.bfloat16, c, hd) for m, c, hd, _, _, _ in calls}
    assert routes == {("flagship", 48, 96): "wgmma", ("lite", 24, 48): "block_stack",
                      ("lite", 48, 96): "wgmma", ("micro", 16, 32): "wgmma",
                      ("micro", 32, 64): "wgmma", ("micro", 64, 128): "wgmma",
                      ("split_heads", 48, 128): "wgmma"}
    assert {bs.stack_route(torch.float32, c, hd) for _, c, hd, _, _, _ in calls} == {"block_stack"}


def test_stack_plan_fits_every_served_call():
    """At every served K3 call the wgmma kernel's plan keeps a tile within
    128 pixels and its region (a 1-pixel halo) within 192, its shared memory
    is the kernel's layout and fits, and the 512x512 flagship call gives
    every SM a CTA; the calls left on block_stack.cu get its plan."""
    for model, c, hidden, h, w, k in _served_stack_calls():
        if bs.stack_route(torch.bfloat16, c, hidden) == "wgmma":
            th, tw, smem = bs.plan_stack_tiles(1, c, hidden, h, w)
            assert th * tw <= bs.STACK_MP and min(th + 2, h) * min(tw + 2, w) <= bs.STACK_MR
            assert smem == bs.stack_smem_bytes(c, hidden) <= gb.SMEM_LIMIT
            if (model, h, w) == ("flagship", 512, 512):
                assert (th, tw) == (8, 16) and -(-h // th) * -(-w // tw) >= gb.NUM_SMS
        else:
            th, tw, hc, smem = gb.plan_tiles(1, c, hidden, h, w, k, 2)
            assert smem <= gb.SMEM_LIMIT and hidden % hc == 0


def test_stack_smem_layout_bytes():
    """The wgmma stack kernel's shared memory counted by hand at the
    flagship's C = 48, H = 96 (3 chunks): y0 192 rows x 128 bytes; per chunk
    8 KB of w1ᵀ and 48 x 64 bytes of w2ᵀ; Y1 192 x 72 f32; y3 128 x 64
    bytes; the tile's input 128 x 52 f32 (26,624 bytes, 1 KB aligned);
    4 mbarriers and 1 KB of alignment slack. And at micro's C = 64, H = 128
    (4 chunks, the input 128 x 68 f32)."""
    want = 24576 + 3 * (8192 + 3072) + 55296 + 8192 + 26624 + 32 + 1024
    assert bs.stack_smem_bytes(48, 96) == want == 149536
    assert bs.stack_smem_bytes(64, 128) == (24576 + 4 * (8192 + 4096) + 55296 + 8192 + 34816
                                            + 32 + 1024)


@pytest.mark.parametrize("bad", [(16, 48), (24, 64), (48, 160), (96, 192)],
                         ids=["hidden48", "c24", "hidden160", "c96"])
def test_stack_plan_raises_off_its_shapes(bad):
    c, hidden = bad
    assert bs.stack_route(torch.bfloat16, c, hidden) == "block_stack"
    with pytest.raises(ValueError, match="takes C in"):
        bs.plan_stack_tiles(1, c, hidden, 64, 64)


def test_stack_scratch_ping_pong():
    """K blocks take 0, 1, 2, 2 scratch planes; block k < K - 1 writes plane
    k mod 2 and block k > 0 reads plane (k - 1) mod 2, so no block reads the
    plane it writes."""
    assert [bs.stack_scratch_planes(k) for k in range(1, 5)] == [0, 1, 2, 2]
    for k_blocks in range(2, 5):
        for k in range(1, k_blocks):
            reads = (k - 1) % 2
            assert reads < bs.stack_scratch_planes(k_blocks)
            assert k == k_blocks - 1 or reads != k % 2
