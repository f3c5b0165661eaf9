"""Snapshots the port can write: ``params_from_torch`` (the reverse of
``params_to_torch``) and ``save_params_npz`` in the JAX package's format,
held against the JAX package's trees, writer and loader; a written snapshot
served by the port's ``predict``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from irdu_tpu.models import registry as jax_registry
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu.utils.weights import save_params_npz as jax_save
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.predict import build_model, denoise, load_model
from irdu_tpu_torch.utils.weights import (f32_to_bf16_bits, load_params_npz, params_from_torch,
                                          params_to_torch, save_params_npz)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them about as fast,
    and the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {
    "flagship": ("abstract_multiscale_graph_filter",
                 dict(dims=(8, 12, 16, 24), hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4),
                      num_blocks=(1, 1, 1, 1), num_blocks_out=1)),
    "flagship_spectral": ("abstract_multiscale_graph_filter",
                          dict(dims=(8, 12, 16, 24), hidden_dims=(16, 24, 32, 48),
                               ngraphs=(2, 2, 4, 4), num_blocks=(1, 1, 1, 1), num_blocks_out=1,
                               conv_variant="spectral_norm")),
    "pixel": ("multiscale_sequence_denoiser",
              dict(n_graphs=2, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
                   feature_num_refinement=1)),
}


def _jax_tree(name):
    """JAX's variables of the model at 16×16, random (shapes from eval_shape,
    values from a seeded numpy draw, so no JAX model runs)."""
    kind, kw = MODELS[name]
    shapes = jax.eval_shape(lambda: jax_registry.create_model(kind, **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    rs = np.random.RandomState(len(name))
    return jax.tree_util.tree_map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", list(MODELS))
def test_params_from_torch_inverts_params_to_torch(name):
    """JAX's tree onto the port's model and back is the identity: every leaf,
    flax names and layouts, the spectral u vectors included."""
    tree = _jax_tree(name)
    kind, kw = MODELS[name]
    model = registry.create_model(kind, **kw)
    params_to_torch(tree, model)
    back = params_from_torch(model)
    assert ("spectral" in back) == ("spectral" in tree)
    ours, theirs = _flat(back), _flat(tree)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_params_from_torch_reads_bf16_and_leaves_out_spectral_when_asked():
    kind, kw = MODELS["flagship_spectral"]
    model = registry.create_model(kind, **kw).to(torch.bfloat16)
    tree = params_from_torch(model, spectral=False)
    assert set(tree) == {"params"}
    w = model.linear_output.weight
    np.testing.assert_array_equal(tree["params"]["linear_output"]["kernel"],
                                  w.detach()[:, :, 0, 0].t().float().numpy())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_port_npz_loads_in_jax_to_jax_writers_arrays(tmp_path, dtype):
    """A port-written snapshot: the same files as JAX's writer gives for the
    same tree (keys, ``::bf16`` uint16 views), and JAX's loader returns the
    same arrays, bit for bit; the port's loader too (bf16 widened)."""
    tree = params_from_torch(build_model("micro"))
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_params_npz(str(ours), tree, dtype=None if dtype is None else torch.bfloat16)
    jax_save(str(theirs), tree, dtype=None if dtype is None else jnp.bfloat16)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, want = _flat(jax_load(str(ours))), _flat(jax_load(str(theirs)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    port = _flat(load_params_npz(str(ours)))
    for k, v in want.items():
        np.testing.assert_array_equal(port[k], v.astype(np.float32))


def test_bf16_rounding_and_tensor_leaves_match_ml_dtypes(tmp_path):
    """The f32 → bf16 rounding is ml_dtypes' (nearest even, ties included),
    and a bf16 tensor leaf is stored as its own bits."""
    x = np.concatenate([np.random.RandomState(0).randn(1000),
                        [1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 65504.0, 1e-40]]).astype(np.float32)
    np.testing.assert_array_equal(f32_to_bf16_bits(x),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))
    t = torch.from_numpy(x).to(torch.bfloat16)
    save_params_npz(str(tmp_path / "t.npz"), {"a": {"b": t}})
    with np.load(tmp_path / "t.npz") as d:
        assert d.files == ["a/b::bf16"]
        np.testing.assert_array_equal(d["a/b::bf16"], t.view(torch.int16).numpy().view(np.uint16))


def test_written_snapshot_is_served_by_predict(tmp_path):
    """A port model written by ``save_params_npz`` loads through
    ``predict.load_model(weights=...)`` and serves the image the model it
    was written from gives (within f32 rounding: the served model's
    parameters need no grad, and CPU convolutions may pick another order)."""
    torch.manual_seed(3)
    model = build_model("micro").eval()
    path = str(tmp_path / "micro.npz")
    save_params_npz(path, params_from_torch(model))
    served = load_model(weights=path, device="cpu", name="micro")
    noisy = np.random.RandomState(1).rand(40, 56, 3).astype(np.float32)
    with torch.inference_mode():
        want = np.clip(model(torch.from_numpy(np.pad(noisy, ((0, 8), (0, 8), (0, 0)),
                                                     mode="reflect"))[None])[0, :40, :56]
                       .numpy(), 0, 1)
    np.testing.assert_allclose(denoise(served, noisy), want, atol=1e-6, rtol=0)
