"""K4 (one LocalNonLinearBlock) of the port against the JAX package's Pallas
kernel in interpret mode, the block kernel's launch plan, the block operands
of the 86k snapshot against the JAX package's, and the lite and micro models
on the card's block kernel: their launch plans, the padded-channel scheme
for C = 24, their default snapshots and their forward against JAX."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF

from irdu_tpu import predict as jax_predict
from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.ops.pallas.gated_block import fused_gated_block as jax_gated_block
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.models.flagship import STACK_MAX_BLOCKS, STACK_MAX_DIM
from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.predict import _CONFIGS, DEFAULT_WEIGHTS, load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _model_calls(name, h, w):
    """(C, hidden, H, W, K) of every block call of one request to a model of
    the family, as models/flagship.py routes them: K3 in chunks of 4 at
    C ≤ 64, K4 elsewhere."""
    cfg = _CONFIGS[name]()
    calls = set()
    for s, (c, hd, n) in enumerate(zip(cfg["dims"], cfg["hidden_dims"], cfg["num_blocks"])):
        lists = [n, n] if s < 3 else [n]  # encoder, decoder (none at scale 3)
        if s == 0:
            lists.append(cfg["num_blocks_out"])
        for n_list in lists:
            ks = ([min(STACK_MAX_BLOCKS, n_list - k) for k in range(0, n_list, STACK_MAX_BLOCKS)]
                  if c <= STACK_MAX_DIM else [1])
            calls.update((c, hd, h >> s, w >> s, k) for k in ks)
    return sorted(calls)


@pytest.mark.parametrize("name", ["lite", "micro"])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_launch_plan_fits_every_lite_and_micro_call(name, esize):
    """The smaller members of the family (lite: C = 24 at scale 0, padded to
    32 in the kernel) at every block shape of the served requests and 512²."""
    for h, w in REQUESTS + ((512, 512),):
        for c, hidden, hh, ww, k in _model_calls(name, h, w):
            assert c % 8 == 0 and hidden % 16 == 0, (c, hidden)
            th, tw, hc, smem = gb.plan_tiles(1, c, hidden, hh, ww, k, esize)
            assert smem == gb.smem_bytes(c, hc, -(-min(th + 2 * k, hh) * min(tw + 2 * k, ww)
                                                  // 16) * 16, esize) <= gb.SMEM_LIMIT
            assert hidden % hc == 0 and (esize == 4 or hc % 16 == 0)


def test_smem_counts_padded_channels():
    """C = 24 takes the shared memory of C = 32, the channels padded to 16."""
    assert gb.smem_bytes(24, 16, 400, 2) == gb.smem_bytes(32, 16, 400, 2)
    assert gb.smem_bytes(24, 16, 400, 4) == gb.smem_bytes(32, 16, 400, 4)
    assert gb.smem_bytes(16, 16, 400, 2) < gb.smem_bytes(24, 16, 400, 2)


def _padded_block(x, p, cp, dtype):
    """The kernel's padded-channel scheme in PyTorch: x and the operands
    zero-padded from C to cp channels, the norm over the true C (variance
    over C − 1, mean not subtracted), the padded outputs dropped."""
    c = x.shape[1]
    xp = tF.pad(x, (0, 0, 0, 0, 0, cp - c))
    mean = xp[:, :c].mean(dim=1, keepdim=True)
    var = ((xp[:, :c] - mean) ** 2).sum(dim=1, keepdim=True) / (c - 1)
    scale = tF.pad(p["scale"].float(), (0, cp - c))
    y0 = gb._round(xp / torch.sqrt(var + gb.EPS) * scale.reshape(1, cp, 1, 1), dtype)
    w1 = tF.pad(p["w1"].to(dtype).float(), (0, 0, 0, cp - c))   # zero rows
    w2 = tF.pad(p["w2"].to(dtype).float(), (0, cp - c))         # zero columns
    y1 = torch.einsum("bchw,co->bohw", y0, w1)
    h, w = x.shape[2:]
    y1p = tF.pad(y1, (1, 1, 1, 1), mode="replicate")
    dw = p["dwk"].float()
    acc = sum(y1p[:, :, a:a + h, b:b + w] * dw[a, b].reshape(1, -1, 1, 1)
              for a in range(3) for b in range(3))
    m, u = acc.chunk(2, dim=1)
    y3 = gb._round(torch.sigmoid(m) * m * u, dtype)
    y4 = torch.einsum("bhxy,hc->bcxy", y3, w2)
    out = p["skip"][0] * xp + p["skip"][1] * y4
    assert torch.equal(out[:, c:], torch.zeros_like(out[:, c:]))  # padding stays zero
    return out[:, :c]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padded_channel_scheme_equals_block(dtype):
    """C = 24 (the lite model's scale 0) padded to 32: equal to the plain
    block at C = 24, rounding y0 and y3 where the kernel does."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 24, 6, 10).astype(np.float32))
    p = {k: torch.from_numpy(v) for k, v in _block_params(rng, 24, 96).items()}
    want = gb.block_f32(x, p["scale"], p["w1"], p["dwk"], p["w2"], p["skip"], dtype)
    torch.testing.assert_close(_padded_block(x, p, 32, dtype), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["lite", "micro"])
def test_small_models_with_snapshots_match_jax(name):
    """lite and micro with their default snapshots (the files JAX's
    default_weights picks) against the JAX jnp path, f32 on the CPU."""
    cfg = {"lite": jax_flagship.flagship_lite_config,
           "micro": jax_flagship.flagship_micro_config}[name]()
    jax_params = jax_load(DEFAULT_WEIGHTS[name], dtype=jnp.float32)
    x = np.random.RandomState(12).rand(1, 64, 96, 3).astype(np.float32)
    ref = np.asarray(JaxFlagship(**cfg).apply(jax_params, jnp.asarray(x)))
    model = load_model(device="cpu", name=name)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["lite", "micro"])
def test_default_weights_are_jax_defaults(name):
    assert os.path.isfile(DEFAULT_WEIGHTS[name])
    assert os.path.abspath(DEFAULT_WEIGHTS[name]) == os.path.abspath(
        jax_predict.default_weights(name))


def test_default_weights_reach_the_card():
    """No snapshot the port loads by default is left off the chip copy."""
    with open(os.path.join(REPO, ".chiprunignore")) as fh:
        ignored = {line.strip() for line in fh if line.strip()}
    assert not {os.path.basename(p) for p in DEFAULT_WEIGHTS.values()} & ignored


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
