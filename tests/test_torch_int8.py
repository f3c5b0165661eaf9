"""The port's int8 pointwise weights (``irdu_tpu_torch/utils/weights.py``)
against the JAX package's: the quantization bit for bit, and int8 snapshots
written by either side read by the other."""

from __future__ import annotations

import numpy as np
import pytest

from irdu_tpu.utils import weights as jax_weights
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS
from irdu_tpu_torch.utils import weights


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def micro_tree():
    return weights.load_params_npz(DEFAULT_WEIGHTS["micro"])


@pytest.mark.parametrize("case", ["seeded", "zero_column", "extremes"])
def test_quantize_kernel_is_jax_bitwise(case):
    w = np.random.RandomState(3).randn(24, 40).astype(np.float32)
    if case == "zero_column":
        w[:, 5] = 0.0
    elif case == "extremes":
        w[0, :] = 1e4
        w[1, :] = -1e-8
    q, s = weights.quantize_kernel_int8(w)
    qj, sj = jax_weights.quantize_kernel_int8(w)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (1, 40)
    assert np.array_equal(q, qj) and np.array_equal(s, sj)


def test_quantize_pointwise_is_jax_bitwise_on_the_micro_snapshot(micro_tree):
    ours = weights.quantize_pointwise_int8(micro_tree)
    ref = jax_weights.quantize_pointwise_int8(micro_tree)
    _same(ours, ref)
    n = sum(1 for k, _ in _leaves(ours) if k.endswith("/__q8__"))
    assert n == sum(1 for k, v in _leaves(micro_tree) if k.endswith("kernel") and v.ndim == 2)
    assert n > 0
    _same(weights.dequantize_pointwise(ours), jax_weights.dequantize_pointwise(
        ref, dtype=np.float32))


def test_port_int8_snapshot_loads_in_jax(micro_tree, tmp_path):
    path = str(tmp_path / "port_int8.npz")
    weights.save_params_npz(path, micro_tree, dtype="bfloat16", int8_pointwise=True)
    ref = str(tmp_path / "jax_int8.npz")
    jax_weights.save_params_npz(ref, micro_tree, dtype=None, int8_pointwise=True)
    q8 = {k: v for k, v in _leaves(jax_weights.load_params_npz(path, keep_int8=True))
          if "__q8" in k}
    q8_ref = {k: v for k, v in _leaves(jax_weights.load_params_npz(ref, keep_int8=True))
              if "__q8" in k}
    assert q8.keys() == q8_ref.keys() and all(np.array_equal(q8[k], q8_ref[k]) for k in q8)
    # the other leaves as bf16, dequantized on load by both sides alike
    _same(weights.load_params_npz(path), _tree_f32(jax_weights.load_params_npz(path)))


def _tree_f32(tree):
    return {k: _tree_f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def test_jax_int8_snapshot_loads_in_the_port(micro_tree, tmp_path):
    path = str(tmp_path / "jax_int8.npz")
    jax_weights.save_params_npz(path, micro_tree, int8_pointwise=True)
    _same(weights.load_params_npz(path, keep_int8=True),
          _keep_q8(jax_weights.load_params_npz(path, keep_int8=True)))
    _same(weights.load_params_npz(path),
          _tree_f32(jax_weights.load_params_npz(path, dtype=np.float32)))


def _keep_q8(tree):
    if "__q8__" in tree:
        return tree
    return {k: _keep_q8(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}
