"""The pixel-domain model in the port against the JAX package: the 72-wide
MultiScaleSequenceDenoiser with the committed snapshot against JAX's jnp
forward on each of the port's routes, the snapshot carry-over, the routing
against JAX's flags at the served request sizes, and predict's pixel model."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu import predict as jax_predict
from irdu_tpu.solvers.pixel_gtv import MixtureGTV as JaxMixtureGTV
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, build_model, denoise, load_model, main
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.utils.weights import load_params_npz, params_to_torch

SNAPSHOT = DEFAULT_WEIGHTS["pixel"]
ROUTES = ("plain", "chw", "nhwc")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


# ---------------------------------------------------------------------------
# the 72-wide model with the committed snapshot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot_forward():
    """JAX's pixel model as its CLI builds it, jnp path, on a seeded 32x64
    image (eager: one forward, ~25 s on a CPU)."""
    x = np.random.RandomState(4).rand(1, 32, 64, 3).astype(np.float32)
    jm = jax_predict.build_model("pixel", fast=False)
    ref = np.asarray(jm.apply(jax_load(SNAPSHOT, dtype=jnp.float32), jnp.asarray(x)))
    return x, ref


@pytest.mark.parametrize("route", list(ROUTES))
def test_snapshot_model_matches_jax(snapshot_forward, route):
    x, ref = snapshot_forward
    model = load_model(device="cpu", name="pixel")
    assert next(model.parameters()).dtype == torch.float32
    mix = model.mixtureGLR_block03
    mix.use_pallas_unroll, mix.use_nhwc_unroll = route == "chw", route == "nhwc"
    assert mix.route() == route
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    assert np.abs(ref - x).max() > 0.05


def test_pixel_snapshot_sets_every_parameter():
    """Every one of the snapshot's 112 leaves lands on a parameter and every
    parameter is set; leaves equal the JAX loader's f32 cast."""
    tree = load_params_npz(SNAPSHOT)
    leaves = dict(_leaves(tree))
    model = build_model("pixel")
    params_to_torch(tree, model)  # raises on a missing or unused leaf
    assert len(leaves) == len(list(model.parameters())) == 112
    assert sum(v.size for v in leaves.values()) == sum(p.numel() for p in model.parameters())
    ref = dict(_leaves(jax_load(SNAPSHOT, dtype=jnp.float32)))
    assert sorted(ref) == sorted(leaves)
    k = "params/mixtureGLR_block03/patchs_features_extraction/encoder_level3_2/ffn/dwconv/kernel"
    np.testing.assert_array_equal(leaves[k], ref[k])
    w = model.mixtureGLR_block03.patchs_features_extraction.encoder_level3_2.ffn.dwconv.weight
    np.testing.assert_array_equal(w.detach().numpy(), ref[k].transpose(3, 2, 0, 1))


# ---------------------------------------------------------------------------
# routing at the served sizes, against JAX's flags
# ---------------------------------------------------------------------------

# (H, W): (JAX with both flags on, the port), then the same with the NHWC flag off.
# JAX's _nhwc_ok and _chw_ok also ask H % 16 == 0 (NHWC), H % 8 == 0 (CHW)
# and W % 128 == 0: TPU band and lane rules the port does not copy, since its
# kernels take any H and W. Where they fail JAX falls back (at 480x320 and
# 484x512 to its jnp path, at 488x512 from NHWC to CHW) and the port keeps the
# route its flags name. Above the cap (1024x1024) both CHW routes run K5
# steps in the pixel mode. denoise pads to /16, so a served request
# has H % 16 == 0; the model called directly may not.
SERVED = {(512, 512): (("nhwc", "nhwc"), ("chw_k7", "chw_k7")),
          (480, 320): (("jnp", "nhwc"), ("jnp", "chw_k7")),
          (1024, 1024): (("nhwc", "nhwc"), ("chw_k5", "chw_k5")),
          (488, 512): (("chw_k7", "nhwc"), ("chw_k7", "chw_k7")),
          (484, 512): (("jnp", "nhwc"), ("jnp", "chw_k7"))}


def _jax_route(m, shape):
    if m.use_nhwc_unroll and m._nhwc_ok(shape):
        return "nhwc"
    if m.use_pallas_unroll and m._chw_ok(shape):
        return "chw_k7" if m._mega_ok(shape) else "chw_k5"
    return "jnp"


def _port_route(m, shape):
    route = m.route()
    if route == "chw":
        return "chw_k7" if shape[-2] * shape[-1] <= gtv_glr._MEGA_MAX_PIXELS else "chw_k5"
    return route


@pytest.mark.parametrize("hw", list(SERVED), ids=lambda s: f"{s[0]}x{s[1]}")
def test_route_agrees_with_jax(hw):
    h, w = hw
    jm = JaxMixtureGTV(use_pallas_unroll=True, use_nhwc_unroll=True)
    port = build_model("pixel").mixtureGLR_block03
    for (want_jax, want_port), nhwc in zip(SERVED[hw], (True, False)):
        jm = jm.clone(use_nhwc_unroll=nhwc)
        port.use_nhwc_unroll = nhwc
        assert _jax_route(jm, (1, h, w, 3)) == want_jax
        assert _port_route(port, (1, 3, h, w)) == want_port
        # the two pick the same kind of route exactly where JAX's TPU rules hold
        tpu_rules = h % (16 if nhwc else 8) == 0 and w % 128 == 0
        assert (want_jax.split("_")[0] == want_port.split("_")[0]) == tpu_rules


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

def test_default_pixel_weights_are_jax_default():
    assert os.path.basename(SNAPSHOT) == "pixel_synthetic_2050.npz"
    assert os.path.abspath(SNAPSHOT) == os.path.abspath(jax_predict.default_weights("pixel"))


def test_build_model_pixel_turns_both_solver_routes_on():
    mix = build_model("pixel").mixtureGLR_block03
    assert mix.use_nhwc_unroll and mix.use_pallas_unroll
    assert (mix.n_graphs, mix.n_node_fts) == (24, 3)


@pytest.mark.parametrize("kw", [dict(cg_iters=1), dict(filter_scales=(1, 2))],
                         ids=["cg_iters", "filter_scales"])
def test_pixel_rejects_flagship_knobs(kw):
    with pytest.raises(ValueError, match="pixel"):
        build_model("pixel", **kw)


def test_cli_serves_pixel(tmp_path, capsys):
    """``--model pixel`` end to end on the CPU: a 40x52 PNG, σ=25 protocol
    noise, the denoised PNG and the JSON report; ``--cg-iters`` is refused."""
    from PIL import Image

    clean = (np.random.RandomState(5).rand(40, 52, 3) * 255).astype(np.uint8)
    src, dst = str(tmp_path / "clean.png"), str(tmp_path / "out.png")
    Image.fromarray(clean).save(src)
    main(["--model", "pixel", "--input", src, "--output", dst, "--sigma", "25"], device="cpu")
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["model"] == "pixel" and report["weights"] == "pixel_synthetic_2050.npz"
    assert report["shape"] == [40, 52] and report["device"] == "cpu"
    assert np.asarray(Image.open(dst)).shape == (40, 52, 3)
    with pytest.raises(SystemExit, match="pixel"):
        main(["--model", "pixel", "--input", src, "--output", dst, "--cg-iters", "1"],
             device="cpu")


def test_load_model_pixel_runs_in_f32_on_cpu():
    model = load_model(name="pixel", device="cpu")
    assert isinstance(model, MultiScaleSequenceDenoiser)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    img = np.random.RandomState(6).rand(20, 28, 3).astype(np.float32)
    out = denoise(model, img)
    assert out.shape == img.shape and out.dtype == np.float32 and np.isfinite(out).all()
