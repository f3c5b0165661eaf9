"""The port's whole flagship model with the 86k snapshot against the JAX
package, f32 on the CPU: the jnp path at two shapes, JAX's kernel fast path,
and the band route (both K1 caps at 0). These are the slowest of the port's
tests; they sit in a file of their own so that ``--dist loadfile`` runs them
on another worker than the rest of test_torch_flagship.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models import flagship as jax_flagship
from irdu_tpu.solvers import gtv_glr as jax_gtv_glr
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.ops.block_stack import fused_block_stack
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw
from irdu_tpu_torch.ops.gated_block import fused_gated_block
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, load_model
from irdu_tpu_torch.solvers import gtv_glr


def _launches():
    return tuple(k.launches for k in (edge_weights_chw, gg_unroll_chw, fused_block_stack,
                                      fused_gated_block, gg_fused_step_chw))


@pytest.fixture(scope="module")
def snapshot_models():
    jax_model = JaxFlagship(**jax_flagship.flagship_config())
    jax_params = jax_load(DEFAULT_WEIGHTS["flagship"], dtype=jnp.float32)
    return jax_model, jax_params, load_model(device="cpu")


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_flagship_with_86k_snapshot_matches_jax(snapshot_models, hw):
    """The whole model, real weights, f32 on the CPU, against the JAX jnp
    path (the CPU tensors run the kernels' plain versions, never a launch);
    square and taller than wide."""
    jax_model, jax_params, model = snapshot_models
    x = np.random.RandomState(0).rand(1, *hw, 3).astype(np.float32)
    ref = np.asarray(jax_model.apply(jax_params, jnp.asarray(x)))
    counts = _launches()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert _launches() == counts
    assert out.shape == (1, *hw, 3)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_flagship_matches_jax_fast_path(snapshot_models):
    """1x64x128x3 (W = 128, so the JAX fast path runs its stacked kernel at
    scale 0 and the per-block kernel elsewhere) against JAX with
    use_pallas_blocks and use_pallas_solver, its kernels in interpret mode."""
    _, jax_params, model = snapshot_models
    x = np.random.RandomState(5).rand(1, 64, 128, 3).astype(np.float32)
    jax_fast = JaxFlagship(**jax_flagship.flagship_config(), use_pallas_blocks=True,
                           use_pallas_solver=True)
    ref = np.asarray(jax_fast.apply(jax_params, jnp.asarray(x)))
    counts = _launches()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert _launches() == counts
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_flagship_band_route_matches_jax_fast_path(snapshot_models, monkeypatch):
    """Both packages' K1 caps at 0, so every filtering block takes the band
    route: the port's K5 steps (plain versions) at all four scales against
    JAX's use_pallas_blocks/use_pallas_solver path (its K5 in interpret mode
    at scale 0, W = 256; its jnp path at the scales its lane rules refuse),
    1x64x256x3 with the 86k snapshot."""
    _, jax_params, model = snapshot_models
    monkeypatch.setattr(jax_gtv_glr, "_MEGA_MAX_PIXELS", 0)
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 0)
    x = np.random.RandomState(11).rand(1, 64, 256, 3).astype(np.float32)
    jax_fast = JaxFlagship(**jax_flagship.flagship_config(), use_pallas_blocks=True,
                           use_pallas_solver=True)
    ref = np.asarray(jax_fast.apply(jax_params, jnp.asarray(x)))
    seen = []

    def counted(*args, **kw):
        seen.append(kw["mode"])
        return gg_fused_step_chw(*args, **kw)

    monkeypatch.setattr(gtv_glr, "gg_fused_step_chw", counted)
    counts = _launches()
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert _launches() == counts
    assert seen == ["rhs", "cg", "rethresh", "cg", "cg"] * 4
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
