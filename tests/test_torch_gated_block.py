"""K4 (one LocalNonLinearBlock) of the port against the JAX package's Pallas
kernel in interpret mode; the wgmma kernel's scheme (tiles with a 1-pixel
halo, the hidden loop in chunks with the project accumulated across them)
transliterated into PyTorch against the plain block and JAX; the launch
plans of the wgmma kernel (bf16) and the block kernel (f32, and K3); the
block operands of the 86k snapshot against the JAX package's; and the lite
and micro models on the card's block kernels: their launch plans, the
padded-channel scheme for C = 24, their default snapshots and their forward
against JAX."""

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


def _wgmma_scheme(x, p, dtype, th, tw, hc=gb.GATED_HC):
    """The wgmma kernel's scheme (kernels/csrc/gated_block.cu) in PyTorch on
    an f32 x: per th x tw tile, y0 over the tile plus a 1-pixel halo
    clipped to the image (two-pass norm, rounded to ``dtype``); per chunk of
    hc m- and hc u-channels the expand over that region, the taps read
    through a clamp to the region, the gate rounded to ``dtype``, and the
    project added to one f32 accumulator across the chunks; s0 x + s1 acc
    at the end, unrounded."""
    b, c, h, w = x.shape
    hidden = p["w2"].shape[0]
    w1, w2 = p["w1"].to(dtype).float(), p["w2"].to(dtype).float()
    dw, sk, scale = p["dwk"].float().reshape(9, -1), p["skip"].float(), p["scale"].float()
    out = torch.empty_like(x)
    for i0 in range(0, h, th):
        for j0 in range(0, w, tw):
            i1, j1 = min(i0 + th, h), min(j0 + tw, w)
            r0, r1, c0, c1 = max(i0 - 1, 0), min(i1 + 1, h), max(j0 - 1, 0), min(j1 + 1, w)
            xr = x[:, :, r0:r1, c0:c1]
            mean = xr.mean(1, keepdim=True)
            var = ((xr - mean) ** 2).sum(1, keepdim=True) / (c - 1)
            y0 = gb._round(xr * (1 / torch.sqrt(var + gb.EPS)) * scale[None, :, None, None],
                           dtype)
            ii = (torch.arange(i0, i1) - r0)[:, None]
            jj = (torch.arange(j0, j1) - c0)[None, :]
            acc = torch.zeros(b, c, i1 - i0, j1 - j0)
            for k0 in range(0, hidden, hc):
                idx = list(range(k0, k0 + hc)) + list(range(hidden + k0, hidden + k0 + hc))
                y1 = torch.einsum("bcij,co->boij", y0, w1[:, idx])
                t = sum(y1[:, :, (ii + a - 1).clamp(0, r1 - r0 - 1),
                           (jj + bb - 1).clamp(0, c1 - c0 - 1)]
                        * dw[3 * a + bb, idx][None, :, None, None]
                        for a in range(3) for bb in range(3))
                m, u = t[:, :hc], t[:, hc:]
                y3 = gb._round(torch.sigmoid(m) * m * u, dtype)
                acc = acc + torch.einsum("bhij,hc->bcij", y3, w2[k0:k0 + hc])
            out[:, :, i0:i1, j0:j1] = sk[0] * x[:, :, i0:i1, j0:j1] + sk[1] * acc
    return out


@pytest.mark.parametrize("th,tw", [(8, 16), (5, 7)], ids=["8x16", "5x7_ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wgmma_scheme_matches_plain_and_jax(dtype, th, tw):
    """C = 96, H = 192 (six chunks of 32) on a 16x20 plane: tiles on every
    image edge, interior tiles, ragged last tiles. f32 within 2e-5 of the
    plain block and of JAX's kernel; bf16 (x, weights and the rounding points
    in bf16) within one bf16 ulp (4e-3 + 2^-7 |ref|) of both: the sums run
    in another order than the plain einsum (a y3 may round the other way),
    and JAX's kernel takes the variance in one pass from bf16 squares."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 16, 20, 96).astype(np.float32)
    p = _block_params(rng, 96, 384)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xq = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype).float()
    out = _wgmma_scheme(xq, tp, dtype, th, tw).to(dtype).float()
    plain = gb.gated_block_plain(xq.to(dtype), **tp).float()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_gated_block(jnp.asarray(xq.permute(0, 2, 3, 1).numpy()).astype(jdt),
                          *(jnp.asarray(p[k]).astype(jdt)
                            for k in ("scale", "w1", "dwk", "w2", "skip")),
                          tile_h=8, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).permute(0, 3, 1, 2)
    assert (plain - xq).abs().max() > 0.5  # the block moved its input
    for want in (plain, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)
        else:
            assert bool(((out - want).abs() <= 4e-3 + 2.0 ** -7 * want.abs()).all())


REQUESTS = ((512, 512), (480, 320), (256, 384))


def _calls(h, w):
    """(C, hidden, H, W, K) of the block calls of one served request: K3 at
    scale 0, K4 at scales 1-3."""
    return [(48, 96, h, w, 4)] + [(48 << s, 96 << s, h >> s, w >> s, 1) for s in (1, 2, 3)]


def _k4_plan(c, hidden, h, w, esize):
    """The plan K4 launches with: the wgmma kernel's in bf16, the block
    kernel's (K = 1) in f32, as (tile_h, tile_w, hc, smem)."""
    if esize == 2:
        th, tw, hc, _, _, smem = gb.plan_gated_tiles(1, c, hidden, h, w)
        return th, tw, hc, smem
    return gb.plan_tiles(1, c, hidden, h, w, 1, esize)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_launch_plan_fits_every_served_call(esize):
    """Every block call of the served requests gets a plan inside the card's
    shared memory; in bf16 the 512x512 calls give at least 120 CTAs."""
    for request in REQUESTS:
        for c, hidden, h, w, k in _calls(*request):
            th, tw, hc, smem = (gb.plan_tiles(1, c, hidden, h, w, k, esize) if k > 1
                                else _k4_plan(c, hidden, h, w, esize))
            assert smem <= gb.SMEM_LIMIT and hidden % hc == 0
            assert esize == 4 or hc % 16 == 0
            if esize == 2 and request == (512, 512):  # no SM left idle for long
                assert -(-h // th) * -(-w // tw) >= 120, (c, h, w, th, tw)


def test_gated_plan_respects_the_kernel():
    """At every K4 shape of the family's served requests the wgmma plan keeps
    a tile's pixels within the project rows (128, or 64 at C = 384) and its
    region within the expand rows mr (192, or 64 at C = 384), and its smem
    is the kernel's layout."""
    shapes = {(c, hd, hh, ww) for name in ("flagship", "lite", "micro")
              for h, w in REQUESTS + ((1024, 1024), (2048, 2048))
              for c, hd, hh, ww, k in _model_calls(name, h, w) if k == 1 and c > 64}
    shapes |= {(96, 256, 512, 512), (96, 256, 256, 256)}  # the ablation heads
    assert {(c, hd) for c, hd, _, _ in shapes} == {(96, 192), (192, 384), (384, 768),
                                                   (128, 256), (96, 256)}
    for c, hidden, h, w in sorted(shapes):
        th, tw, hc, mr, mp, smem = gb.plan_gated_tiles(1, c, hidden, h, w)
        assert (hc, mp) == (gb.GATED_HC, 64 if c > 192 else 128)
        assert th * tw <= mp and mr == (64 if c > 192 else 192)
        assert min(th + 2, h) * min(tw + 2, w) <= mr
        assert smem == gb.gated_smem_bytes(c, mr, mp) <= gb.SMEM_LIMIT


def test_gated_smem_layout_bytes():
    """The wgmma kernel's shared memory counted by hand at C = 192, an 8x16
    tile (a 10x18 region in mr = 192 expand rows, mp = 128) and 2 slots a
    ring: y0 3 blocks x 192 rows x 128 bytes; an expand slot 3 x 8 KB, a
    project slot 192 x 64 bytes; Y1 192 x 72 f32; y3 128 x 64 bytes; 8
    mbarriers and 1 KB of alignment slack."""
    want = 73728 + 2 * (24576 + 12288) + 55296 + 8192 + 64 + 1024
    assert gb.gated_smem_bytes(192, 192, 128) == want == 212032
    assert gb.plan_gated_tiles(1, 192, 384, 128, 128) == (8, 16, 32, 192, 128, want)


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
            if k == 1 and c > 64 and esize == 2:  # K4 in bf16: the wgmma kernel
                th, tw, hc, mr, mp, smem = gb.plan_gated_tiles(1, c, hidden, hh, ww)
                assert smem == gb.gated_smem_bytes(c, mr, mp) <= gb.SMEM_LIMIT
            else:
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


@pytest.mark.parametrize("plan", ["block_kernel", "gated_channels", "gated_hidden"])
def test_plan_raises_when_nothing_fits(plan):
    """The block kernel's plan (K3, f32 K4) when no tile fits shared memory;
    the wgmma kernel's for a C it is not built for or an H not in chunks of
    32."""
    if plan == "block_kernel":
        with pytest.raises(ValueError, match="shared memory"):
            gb.plan_tiles(1, 4096, 8192, 64, 64, 1, 2)
    else:
        c, hidden = (4096, 8192) if plan == "gated_channels" else (96, 200)
        with pytest.raises(ValueError, match="takes C in"):
            gb.plan_gated_tiles(1, c, hidden, 64, 64)


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
