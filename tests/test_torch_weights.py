"""The port's snapshot loader and weight carry-over against the JAX package:
the npz loader, the flax → torch layout maps of every layer type, and the
86k flagship snapshot onto the port's model."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models import layers as jlayers
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu.utils.weights import save_params_npz
from irdu_tpu_torch.models import layers
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, build_model
from irdu_tpu_torch.utils.weights import load_params_npz, params_to_torch

SNAPSHOT = DEFAULT_WEIGHTS["flagship"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_snapshot_is_pinned_to_86k():
    assert os.path.basename(SNAPSHOT) == "flagship_cont100k_35000.npz"
    assert os.path.isfile(SNAPSHOT)


def test_loader_matches_jax_loader_on_86k_snapshot():
    """bf16 leaves widen exactly: every leaf equals the JAX loader's f32 cast."""
    ours = dict(_leaves(load_params_npz(SNAPSHOT)))
    ref = dict(_leaves(jax_load(SNAPSHOT, dtype=jnp.float32)))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_86k_snapshot_sets_every_parameter():
    """Every snapshot key is used and every parameter set: 13,278,816 params."""
    tree = load_params_npz(SNAPSHOT)
    model = build_model("flagship")
    params_to_torch(tree, model)  # raises on a missing or unused key
    assert len(list(_leaves(tree))) == len(list(model.parameters()))
    assert sum(p.numel() for p in model.parameters()) == 13_278_816
    w = tree["params"]["linear_output"]["kernel"]
    np.testing.assert_array_equal(model.linear_output.weight[:, :, 0, 0].detach().numpy(), w.T)


def test_int8_snapshot_dequantizes_like_jax(tmp_path):
    rng = np.random.RandomState(0)
    params = {"params": {"a": {"kernel": rng.randn(8, 5).astype(np.float32)},
                         "b": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)},
                         "skip": np.ones(2, np.float32)}}
    path = str(tmp_path / "q8.npz")
    save_params_npz(path, params, dtype=jnp.bfloat16, int8_pointwise=True)
    ours = dict(_leaves(load_params_npz(path)))
    ref = dict(_leaves(jax_load(path, dtype=jnp.float32)))
    assert sorted(ours) == sorted(ref) == ["params/a/kernel", "params/b/kernel",
                                           "params/skip"]
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_params_to_torch_rejects_mismatched_snapshots(fault):
    tree = load_params_npz(SNAPSHOT)
    head = tree["params"]["linear_output"]
    if fault == "missing":
        del tree["params"]["linear_output"]
    elif fault == "unused":
        head["bias"] = np.zeros(3, np.float32)
    else:
        head["kernel"] = head["kernel"][:-1]
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        params_to_torch(tree, build_model("flagship"))


LAYERS = [
    ("pointwise", lambda: jlayers.GroupedPointwise(features=6),
     lambda: layers.GroupedPointwise(4, 6), 4),
    ("conv3x3", lambda: jlayers.Conv3x3Replicate(features=5),
     lambda: layers.Conv3x3Replicate(3, 5), 3),
    ("depthwise3x3", lambda: jlayers.Conv3x3Replicate(features=6, groups=6),
     lambda: layers.Conv3x3Replicate(6, 6, groups=6), 6),
    ("down2x2", lambda: jlayers.Downsample2x2(features=5),
     lambda: layers.Downsample2x2(3, 5), 3),
    ("up2x2", lambda: jlayers.Upsample2x2(features=3),
     lambda: layers.Upsample2x2(5, 3), 5),
]


@pytest.mark.parametrize("name,jax_layer,torch_layer,c_in", LAYERS,
                         ids=[l[0] for l in LAYERS])
def test_layer_layout_maps_match_flax(name, jax_layer, torch_layer, c_in):
    """Each flax kernel layout lands on the torch layer that computes the
    same function: NHWC flax apply == NCHW torch forward."""
    x = np.random.RandomState(1).randn(2, 8, 10, c_in).astype(np.float32)
    jl = jax_layer()
    params = jl.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(jl.apply(params, jnp.asarray(x)))
    tl = torch_layer()
    params_to_torch(jax.tree_util.tree_map(np.asarray, params), tl)
    with torch.no_grad():
        out = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
