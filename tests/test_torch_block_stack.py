"""K3 (up to four stacked LocalNonLinearBlocks) of the port against the JAX
package's Pallas kernel in interpret mode, the stacked operands of the 86k
snapshot against the JAX package's, and the kernel's tiling scheme (each
tile with a K-pixel halo, taps clamped to the tile's region) run in plain
PyTorch against the block-by-block plain version."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.ops.pallas.block_stack import fused_block_stack as jax_block_stack
from irdu_tpu.ops.pallas.block_stack import pack_block_params as jax_pack
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.ops.block_stack import block_stack_plain, fused_block_stack, pack_block_params
from irdu_tpu_torch.ops.gated_block import block_f32, gated_block_plain
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, load_model


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
