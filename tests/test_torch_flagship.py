"""The port's flagship model and serving entry against the JAX package, plus
the port's boundary rules: no JAX in its sources, no launch from a CPU
tensor, and a chip smoke run that refuses to run without a card. The whole
model against JAX at its three routes is in test_torch_flagship_snapshot.py
(a file of its own, so that a worker per file runs it beside this one)."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models import chw as jax_chw
from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.models import flagship
from irdu_tpu_torch.models.layers import Downsample2x2, GroupedPointwise, Upsample2x2
from irdu_tpu_torch.ops.block_stack import fused_block_stack
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw
from irdu_tpu_torch.ops.gated_block import fused_gated_block
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, build_model, denoise, load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches():
    return tuple(k.launches for k in (edge_weights_chw, gg_unroll_chw, fused_block_stack,
                                      fused_gated_block, gg_fused_step_chw))


@pytest.fixture(scope="module")
def snapshot_models():
    jax_model = JaxFlagship(**jax_flagship.flagship_config())
    jax_params = jax_load(DEFAULT_WEIGHTS["flagship"], dtype=jnp.float32)
    return jax_model, jax_params, load_model(device="cpu")


def test_eval_filter_scales_match_jax(snapshot_models):
    """Filtering only scales 1-3, the scale-0 code passed through."""
    _, jax_params, _ = snapshot_models
    x = np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32)
    jax_model = JaxFlagship(**jax_flagship.flagship_config(), eval_filter_scales=(1, 2, 3))
    ref = np.asarray(jax_model.apply(jax_params, jnp.asarray(x)))
    model = load_model(device="cpu", filter_scales=(1, 2, 3))
    assert model.eval_filter_scales == (1, 2, 3)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_block_kernel_route_matches_module_route(snapshot_models):
    """use_kernels off runs every block as its module's ops, the on-card
    reference of the kernel route; on the CPU both agree in f32."""
    _, _, model = snapshot_models
    x = torch.from_numpy(np.random.RandomState(7).rand(1, 32, 48, 3).astype(np.float32))
    with torch.inference_mode():
        codes = model.encode(x)
        model.use_kernels = False
        try:
            ref_codes = model.encode(x)
        finally:
            model.use_kernels = True
    for c, r in zip(codes, ref_codes):
        torch.testing.assert_close(c, r, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("layer", ["downsample", "upsample", "pointwise"])
def test_chw_layers_match_jax_chw_helpers(layer):
    """The port's channels-first layers compute the JAX fast path's CHW
    helpers (irdu_tpu/models/chw.py) with the same flax kernels."""
    rng = np.random.RandomState(8)
    c_in, c_out = 12, 8
    x = rng.randn(2, c_in, 8, 6).astype(np.float32)
    if layer == "downsample":
        kern, mod = rng.randn(4 * c_in, c_out), Downsample2x2(c_in, c_out)
        ref = jax_chw.downsample2x2_chw(jnp.asarray(x), jnp.asarray(kern, jnp.float32))
    elif layer == "upsample":
        kern, mod = rng.randn(c_in, 4 * c_out), Upsample2x2(c_in, c_out)
        ref = jax_chw.upsample2x2_chw(jnp.asarray(x), jnp.asarray(kern, jnp.float32))
    else:
        kern, mod = rng.randn(c_in, c_out), GroupedPointwise(c_in, c_out)
        ref = jax_chw.pointwise_chw(jnp.asarray(x), jnp.asarray(kern, jnp.float32))
    with torch.no_grad():
        mod.weight.copy_(mod.kernel_to_torch(torch.from_numpy(kern.astype(np.float32))))
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_denoise_matches_jax_pad_forward_crop(snapshot_models):
    """predict.denoise on a 50×70 image: reflect pad to 64×80, forward, crop,
    clamp — against the same steps around the JAX model."""
    jax_model, jax_params, model = snapshot_models
    rs = np.random.RandomState(2204)
    clean = np.kron(rs.rand(5, 7, 3), np.ones((10, 10, 1)))
    noisy = (clean + rs.normal(0, 25 / 255, clean.shape)).astype(np.float32)
    pad = np.pad(noisy, ((0, 14), (0, 10), (0, 0)), mode="reflect")
    ref = np.clip(np.asarray(jax_model.apply(jax_params, jnp.asarray(pad[None])))[0, :50, :70],
                  0.0, 1.0)
    out = denoise(model, noisy)
    assert out.shape == (50, 70, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


TINY = dict(n_channels_in=3, n_channels_out=3, dims=(8, 12, 16, 24),
            hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4),
            num_blocks=(1, 1, 1, 1), num_blocks_out=1)


def test_encode_filter_decode_compose():
    model = flagship.AbstractMultiScaleGraphFilter(**TINY).eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 32, 48, 3).astype(np.float32))
    with torch.no_grad():
        codes = model.encode(x)
        assert [tuple(c.shape) for c in codes] == [
            (1, 8, 32, 48), (1, 12, 16, 24), (1, 16, 8, 12), (1, 24, 4, 6)]
        np.testing.assert_array_equal(model.enc_dec(x).numpy(), model.decode(codes).numpy())
        np.testing.assert_array_equal(model(x).numpy(),
                                      model.decode(model.filtering(codes)).numpy())


@pytest.mark.parametrize("name", ["flagship", "lite", "micro"])
def test_config_parameter_counts_match_jax(name):
    jax_cfg = {"flagship": jax_flagship.flagship_config,
               "lite": jax_flagship.flagship_lite_config,
               "micro": jax_flagship.flagship_micro_config}[name]()
    shapes = jax.eval_shape(lambda: JaxFlagship(**jax_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in build_model(name).parameters()) == n_jax


FORBIDDEN = ("jax", "flax", "ml_dtypes", "irdu_tpu")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "irdu_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(paths) > 10
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {f"irdu_tpu_torch/{m}.py" for m in (
        "data/synthetic", "data/degradations", "eval/metrics", "eval/harness", "eval/curve",
        "parallel/spatial", "parallel/mesh", "parallel/tensor")} <= rel
    bad = [(os.path.relpath(p, REPO), m) for p in paths for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
