"""K2 (edge weights) of the port against the JAX package's Pallas kernel,
run in interpret mode; the JAX side takes lane-padded features and a true
width below the padded one, the port the true width."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_chw import edge_weights_chw as jax_edge_weights
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain

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
