"""K3's ``dw_mxu`` option (the expand folded into the depthwise taps, nine
tap products a block): the port's plain version against the JAX package's
``fused_block_stack(dw_mxu=True)`` in interpret mode (rel < 2e-5, as
tests/test_block_stack.py holds JAX's kernel to its reference), the tap
matrices' packing against JAX's, the CUDA kernel's scheme
(``kernels/csrc/block_stack_dw_mxu.cu``: tiles of at most 128 pixels whose
rows are the products' M, each tap's rows read at the shifted pixel clamped
to the region, hidden chunks of 32 m- and 32 u-channels, the gate and the
project per chunk) transliterated against the plain version, its register
fragments' index maps, and the wrapper's routes on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.block_stack import fused_block_stack as jax_stack
from irdu_tpu.ops.pallas.block_stack import pack_block_params as jax_pack
from irdu_tpu_torch.ops import block_stack as bs
from irdu_tpu_torch.ops.gated_block import SMEM_LIMIT, subnet_norm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(rng, c, hidden2, k):
    """K seeded blocks in JAX's per-block layout (tests/test_block_stack.py)."""
    h = hidden2 // 2
    return [dict(scale=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
                 w1=(rng.randn(c, hidden2) / np.sqrt(c)).astype(np.float32),
                 dwk=(0.3 * rng.randn(3, 3, hidden2)).astype(np.float32),
                 w2=(rng.randn(h, c) / np.sqrt(h)).astype(np.float32),
                 skip=np.array([1.0, 0.7], np.float32)) for _ in range(k)]


def _torch_operands(blocks, dtype):
    return bs.pack_block_params([{k: torch.from_numpy(v) for k, v in b.items()}
                                 for b in blocks], dtype)


@pytest.mark.parametrize("c,hidden2", [(16, 64), (48, 192)], ids=["c16", "c48_flagship"])
def test_dw_mxu_plain_matches_jax_kernel(c, hidden2):
    """f32, K = 2 blocks on (1, C, 16, 128): the plain version against JAX's
    dw_mxu kernel in interpret mode, max|d| / max|ref| < 2e-5; and equal to
    the unfolded function (``block_stack_plain``) within f32 rounding."""
    rng = np.random.RandomState(c)
    x = (0.5 * rng.randn(1, c, 16, 128)).astype(np.float32)
    blocks = _blocks(rng, c, hidden2, 2)
    want = np.asarray(jax_stack(jnp.asarray(x), *jax_pack(blocks, jnp.float32), dw_mxu=True,
                                interpret=True))
    ops = _torch_operands(blocks, torch.float32)
    got = bs.block_stack_dw_mxu_plain(torch.from_numpy(x), *ops).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-5, rel
    assert np.abs(want - x).max() > 0.1  # the blocks moved their input
    unfolded = bs.block_stack_plain(torch.from_numpy(x), *ops).numpy()
    assert np.abs(unfolded - got).max() / np.abs(want).max() < 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_dw_taps_matches_jax(dtype):
    """m9[k, t] = w1ᵀ[k] ⊙ dwk[k, t], the f32 product rounded to x's dtype:
    bit for bit JAX's packing (``(w1t[:, None].astype(f32) * dwk).astype``)."""
    rng = np.random.RandomState(5)
    blocks = _blocks(rng, 32, 128, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, w1t, dwk, _, _ = jax_pack(blocks, jdt)
    want = np.asarray((w1t[:, None].astype(jnp.float32) * dwk).astype(jdt).astype(jnp.float32))
    _, tw1t, tdwk, _, _ = _torch_operands(blocks, tdt)
    got = bs.pack_dw_taps(tw1t, tdwk, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (3, 9, 128, 32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _fragments():
    """The kernel's register maps, per thread (warpgroup wg, warp wi, lane):
    the ldmatrix row (tile pixel, k half) a lane addresses; the accumulator
    D's (pixel, hidden column) of register i; the project accumulator's
    (pixel, channel pair) of register i (i even), at C = 48."""
    lds, gate, proj = [], [], []
    for wg in range(2):
        for wi in range(4):
            for lane in range(32):
                mi = lane // 8
                lds.append((wg * 64 + wi * 16 + lane % 8 + 8 * (mi & 1), 8 * (mi >> 1)))
                for i in range(32):
                    gate.append((wg * 64 + wi * 16 + lane // 4 + 8 * ((i % 4) // 2),
                                 8 * (i // 4) + 2 * (lane % 4) + i % 2))
                for i in range(0, 24, 2):
                    proj.append((wg * 64 + wi * 16 + lane // 4 + 8 * ((i % 4) // 2),
                                 8 * (i // 4) + 2 * (lane % 4)))
    return lds, gate, proj


def test_fragment_maps_cover_the_tile_once():
    """Every (pixel, k half) of the tile's 128 rows is one lane's ldmatrix
    row; D's registers i and i + 16 hold hidden columns c and c + 32 (m and
    u of one channel) of one pixel and cover the 128 x 64 tile once; the
    project's even registers cover every (pixel, channel pair) once."""
    lds, gate, proj = _fragments()
    assert sorted(lds) == [(p, k) for p in range(128) for k in (0, 8)]
    assert sorted(gate) == [(p, n) for p in range(128) for n in range(64)]
    for wg in range(2):
        for wi in range(4):
            for lane in range(32):
                base = ((wg * 4 + wi) * 32 + lane) * 32
                for i in range(16):
                    (p, col), (pu, colu) = gate[base + i], gate[base + i + 16]
                    assert pu == p and colu == col + 32 and col < 32
    assert sorted(proj) == [(p, n) for p in range(128) for n in range(0, 48, 2)]


def _dw_scheme(x, scales, w1t, dwk, w2t, skips, th, tw):
    """The kernel's computation in f32, transliterated: per block, per th x tw
    tile, the region (the tile and a 1-pixel halo, clipped to the image)
    normalized into y0 rows; 128 product rows, tile pixel p = row (a row
    past the tile reads the tile's last pixel, and its results are dropped),
    each tap's rows the pixel shifted by the tap and clamped to the region;
    per chunk j of 32 m- and 32 u-channels D = sum_t y0[rows_t] m9[t, chunk]ᵀ,
    the gate, the project accumulated over the chunks; the epilogue
    s0·x + s1·acc from the block's input. Cells no tile writes stay NaN."""
    m9 = bs.pack_dw_taps(w1t, dwk, torch.float32)
    _, c, h, w = x.shape
    k_blocks, hidden = w2t.shape[0], w2t.shape[2]
    cur = x.float()
    for k in range(k_blocks):
        out = torch.full_like(cur, float("nan"))
        for ti0 in range(0, h, th):
            for tj0 in range(0, w, tw):
                ti1, tj1 = min(ti0 + th, h), min(tj0 + tw, w)
                r0, r1, c0, c1 = max(ti0 - 1, 0), min(ti1 + 1, h), max(tj0 - 1, 0), min(tj1 + 1, w)
                rh, rw = r1 - r0, c1 - c0
                assert rh * rw <= bs.STACK_MR and th * tw <= bs.STACK_MP
                region = cur[0, :, r0:r1, c0:c1]
                y0 = (subnet_norm(region[None])[0] * scales[k].reshape(c, 1, 1)).reshape(c, -1).t()
                p = torch.arange(bs.STACK_MP)
                li = torch.clamp(p // tw, max=ti1 - ti0 - 1)
                lj = torch.clamp(p % tw, max=tj1 - tj0 - 1)
                acc = torch.zeros(bs.STACK_MP, c)
                for j in range(hidden // 32):
                    chunk = torch.cat([torch.arange(32 * j, 32 * j + 32),
                                       hidden + torch.arange(32 * j, 32 * j + 32)])
                    d = torch.zeros(bs.STACK_MP, 64)
                    for tap in range(9):
                        ri = torch.clamp(ti0 + li + tap // 3 - 1 - r0, 0, rh - 1)
                        rj = torch.clamp(tj0 + lj + tap % 3 - 1 - c0, 0, rw - 1)
                        d += y0[ri * rw + rj] @ m9[k, tap, chunk].t()
                    m, u = d[:, :32], d[:, 32:]
                    acc += (torch.sigmoid(m) * m * u) @ w2t[k, :, 32 * j:32 * j + 32].float().t()
                keep = (p < th * tw) & (p // tw < ti1 - ti0) & (p % tw < tj1 - tj0)
                pi, pj = ti0 + p[keep] // tw, tj0 + p[keep] % tw
                s0, s1 = skips[k].float()
                out[0, :, pi, pj] = s0 * cur[0, :, pi, pj] + s1 * acc[keep].t()
        cur = out
    return cur


@pytest.mark.parametrize("th,tw,k", [(8, 16, 3), (5, 7, 2), (12, 10, 1)],
                         ids=["8x16_k3", "5x7_ragged_k2", "12x10_k1"])
def test_kernel_scheme_matches_plain(th, tw, k):
    """The transliterated kernel on a 19x23 plane (tiles on every edge,
    ragged last tiles, rows past a tile) equals the plain version in f32,
    C = 32, H = 64 (two hidden chunks)."""
    rng = np.random.RandomState(th * tw + k)
    x = torch.from_numpy((0.5 * rng.randn(1, 32, 19, 23)).astype(np.float32))
    ops = _torch_operands(_blocks(rng, 32, 128, k), torch.float32)
    got = _dw_scheme(x, *ops, th, tw)
    want = bs.block_stack_dw_mxu_plain(x, *ops)
    assert not torch.isnan(got).any()
    assert (want - x).abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_wrapper_routes_on_the_cpu():
    """``fused_block_stack(dw_mxu=True)`` on the CPU is the plain version and
    launches nothing; a subnet count above 1 raises (JAX's kernel takes
    none); the kernel's shared memory fits a CTA at every C and H it takes."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy((0.5 * rng.randn(1, 16, 9, 11)).astype(np.float32))
    ops = _torch_operands(_blocks(rng, 16, 64, 2), torch.float32)
    before = (bs.fused_block_stack.launches, bs.fused_block_stack.dw_mxu_launches)
    got = bs.fused_block_stack(x, *ops, dw_mxu=True)
    assert (bs.fused_block_stack.launches, bs.fused_block_stack.dw_mxu_launches) == before
    torch.testing.assert_close(got, bs.block_stack_dw_mxu_plain(x, *ops), atol=0, rtol=0)
    with pytest.raises(ValueError, match="subnet"):
        bs.fused_block_stack(x, *ops, nsubnets=2, dw_mxu=True)
    for c in bs.STACK_CHANNELS:
        for hidden in range(32, bs.STACK_MAX_HIDDEN + 1, 32):
            assert bs.dw_mxu_smem_bytes(c, hidden) <= SMEM_LIMIT
