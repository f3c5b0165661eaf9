"""K4 (one LocalNonLinearBlock) of the port against the JAX package's Pallas
kernel in interpret mode, the block kernel's launch plan, and the block
operands of the 86k snapshot against the JAX package's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.ops.pallas.gated_block import fused_gated_block as jax_gated_block
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, load_model


def _block_params(rng, c, h2):
    return dict(scale=(rng.randn(c) * 0.1 + 1.0).astype(np.float32),
                w1=(rng.randn(c, h2) / np.sqrt(c)).astype(np.float32),
                dwk=(rng.randn(3, 3, h2) * 0.2).astype(np.float32),
                w2=(rng.randn(h2 // 2, c) / np.sqrt(h2 // 2)).astype(np.float32),
                skip=np.array([0.8, 0.5], np.float32))


@pytest.mark.parametrize("b,c,h2,h,w", [(2, 8, 24, 16, 16), (1, 96, 384, 8, 16)],
                         ids=["C8", "C96"])
def test_gated_block_matches_jax_kernel(b, c, h2, h, w):
    """The JAX side is NHWC, the port CHW; the port's CPU call runs the plain
    version and counts no launch."""
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, c).astype(np.float32)
    p = _block_params(rng, c, h2)
    ref = np.asarray(jax_gated_block(jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                                     ("scale", "w1", "dwk", "w2", "skip")),
                                     tile_h=8, interpret=True))
    launches = gb.fused_gated_block.launches
    out = gb.fused_gated_block(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                               **{k: torch.from_numpy(v) for k, v in p.items()})
    assert gb.fused_gated_block.launches == launches
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=2e-5, rtol=1e-4)


def test_gated_block_rejects_wrong_operand_shapes():
    rng = np.random.RandomState(1)
    p = {k: torch.from_numpy(v) for k, v in _block_params(rng, 8, 24).items()}
    x = torch.zeros(1, 8, 8, 8)
    with pytest.raises(ValueError, match="w2"):
        gb.fused_gated_block(x, **{**p, "w2": p["w2"].t()})
    with pytest.raises(ValueError, match="x must be"):
        gb.fused_gated_block(x[0], **p)


REQUESTS = ((512, 512), (480, 320), (256, 384))


def _calls(h, w):
    """(C, hidden, H, W, K) of the block calls of one served request: K3 at
    scale 0, K4 at scales 1-3."""
    return [(48, 96, h, w, 4)] + [(48 << s, 96 << s, h >> s, w >> s, 1) for s in (1, 2, 3)]


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_launch_plan_fits_every_served_call(esize):
    """Every block call of the served requests gets a plan inside the card's
    shared memory; in bf16 the 512x512 calls give at least 120 CTAs."""
    for request in REQUESTS:
        for c, hidden, h, w, k in _calls(*request):
            th, tw, hc, smem = gb.plan_tiles(1, c, hidden, h, w, k, esize)
            assert smem <= gb.SMEM_LIMIT and hidden % hc == 0
            assert esize == 4 or hc % 16 == 0
            if esize == 2 and request == (512, 512):  # no SM left idle for long
                assert -(-h // th) * -(-w // tw) >= 120, (c, h, w, th, tw)


def test_smem_layout_bytes():
    """The shared-memory layout the kernel uses, counted by hand for K3 at
    scale 0 in bf16 on an (8, 16) tile with a 4-pixel halo: 384 pixels."""
    c, hc, nrp, ldx = 48, 16, 384, 392  # 392 words = 8 mod 32
    want = (4 * c * ldx + 4 * 2 * hc * ldx + 4 * 9 * 2 * hc + 2 * nrp * 56 + 2 * nrp * 24
            + 2 * 32 * 56 + 2 * c * 24)
    assert gb.smem_bytes(c, hc, nrp, 2) == want == 193920
    assert gb.smem_bytes(c, 32, nrp, 2) > gb.SMEM_LIMIT
    # the plan for K3 at 512x512: 12x12 tiles, 1849 CTAs in 15 waves of 132,
    # each a 20x20 region (400 pixels, 400 + 12 per CTA) against 16 waves of
    # 384-pixel regions for 8x16 tiles
    th, tw, hc, smem = gb.plan_tiles(1, 48, 96, 512, 512, 4, 2)
    assert (th, tw, hc) == (12, 12, 16)
    assert smem == gb.smem_bytes(48, 16, 400, 2) <= gb.SMEM_LIMIT


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        gb.plan_tiles(1, 4096, 8192, 64, 64, 1, 2)


@pytest.fixture(scope="module")
def snapshot_blocks():
    jax_model = jax_flagship.AbstractMultiScaleGraphFilter(**jax_flagship.flagship_config())
    bound = jax_model.bind(jax_load(DEFAULT_WEIGHTS["flagship"], dtype=jnp.float32))
    return bound, load_model(device="cpu")


@pytest.mark.parametrize("where", [("encoder_scales", 1, 0), ("decoder_scales", 2, 5),
                                   ("encoder_scales", 3, 7), ("refining_block", None, 3)],
                         ids=lambda w: f"{w[0]}{w[1] if w[1] is not None else ''}_{w[2]}")
def test_gated_params_of_snapshot_equal_jax(snapshot_blocks, where):
    bound, model = snapshot_blocks
    name, s, i = where
    jax_block = getattr(bound, name)[i] if s is None else getattr(bound, name)[s][i]
    block = getattr(model, name)[i] if s is None else getattr(model, name)[s][i]
    want, got = jax_block.gated_params(), block.gated_params()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].detach().numpy(), np.asarray(want[key]),
                                      err_msg=key)
