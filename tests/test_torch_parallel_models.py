"""Tensor parallelism for every model in the port, under JAX's placement
rules: ``param_shardings`` against JAX's ``spec_for_param`` leaf by leaf
and axis by axis for the 16 registry names (at their defaults); the port's
refusal (``check_tp_divisibility``) against JAX's, computed from
``jax.eval_shape`` with no devices (an uneven placement, which
``jax.device_put`` refuses, or the flagship family's hidden/graph rule),
for every ``configs/*.yaml`` at tp 2, 4 and 8; and a tp = 2 train step on
spawned gloo ranks equal to one process for the ablation
``multiscale_graph_filter`` (its MixtureGTVGLR experts and its heads' gated
blocks split), a DnCNN (nothing placed), the tiny flagship at nsubnets
(2, 2, 1, 1) (grouped blocks gathered where they are used) and a Restormer
of even widths (its ``project_out`` kernels gathered): the loss within
1e-4, the gathered gradients within atol=5e-5, rtol=1e-3, the gathered
parameters and Adam moments (tests/test_torch_parallel_mesh.py's bars)."""

from __future__ import annotations

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irdu_tpu.models import registry as jax_registry
from irdu_tpu.parallel.tensor import MODEL_AXIS as JAX_MODEL_AXIS
from irdu_tpu.parallel.tensor import spec_for_param as jax_spec_for_param
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.parallel.tensor import check_tp_divisibility, param_shardings

import torch_parallel_ranks as ranks
from test_torch_parallel_mesh import _flax_path_and_axis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(REPO, "configs",
                                                                          "*.yaml")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_axes(jax_model):
    """{flax path: the axis JAX places on the model axis, or None} of the
    model's params at 16x16, from shapes alone."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 16, 16, 3))))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        spec = tuple(jax_spec_for_param(path, leaf))
        out[tuple(str(getattr(k, "key", k)) for k in path)] = (
            spec.index(JAX_MODEL_AXIS) if JAX_MODEL_AXIS in spec else None, leaf.shape)
    return out


def _port_axes(model):
    """The same of the port's model, through each placement's layout."""
    out = {}
    for name, pl in param_shardings(model).items():
        if pl is not None and pl.view is not None:
            owner = name.rpartition(".")[0]
            out[tuple(owner.split(".")) + ("kernel",)] = pl.dim
        elif pl is not None:
            path, axis = _flax_path_and_axis(model, name, pl.dim)
            out[path] = axis
        else:
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            if leaf == "weight" and hasattr(mod, "kernel_from_torch"):
                leaf = "kernel"
            else:
                leaf = {v: k for k, v in getattr(mod, "FLAX_NAMES", {}).items()}.get(leaf, leaf)
            out[tuple(owner.split(".")) + (leaf,) if owner else (leaf,)] = None
    return out


@pytest.mark.parametrize("name", registry.available_models())
def test_placement_equals_jax_for_every_model(name):
    """Every parameter the port's model has is placed on JAX's axis of the
    same flax leaf, or whole where JAX keeps it whole; no leaf is missed."""
    jax_axes = _jax_axes(jax_registry.create_model(name))
    port = _port_axes(registry.create_model(name))
    assert set(port) == set(jax_axes)
    for path, axis in port.items():
        assert axis == jax_axes[path][0], (path, axis, jax_axes[path])


def _jax_refuses(jax_model, axes, tp):
    """Whether JAX's trainer refuses the model at tp: a placed leaf's size
    along the model axis that tp does not divide (``device_put`` raises), or
    the flagship family's ``check_tp_divisibility`` assertion."""
    if hasattr(jax_model, "hidden_dims"):
        if any(2 * h % tp for h in jax_model.hidden_dims) or any(
                g % tp for g in jax_model.ngraphs):
            return True
    return any(axis is not None and shape[axis] % tp for axis, shape in axes.values())


_CONFIG_AXES = {}  # JAX's axes by model section: configs that share one trace it once


@pytest.mark.parametrize("config", CONFIGS)
def test_refusal_equals_jax_for_every_config(config):
    """At tp 2, 4 and 8 the port refuses a config exactly where JAX refuses
    its placement, with a ValueError naming the reason."""
    with open(os.path.join(REPO, "configs", f"{config}.yaml")) as fh:
        section = yaml.safe_load(fh)["model"]
    kw = dict(section)
    name = kw.pop("type")
    jax_model, port = jax_registry.create_model(name, **kw), registry.create_model(name, **kw)
    key = json.dumps(section, sort_keys=True)
    if key not in _CONFIG_AXES:
        _CONFIG_AXES[key] = _jax_axes(jax_model)
    axes = _CONFIG_AXES[key]
    for tp in (2, 4, 8):
        refused = _jax_refuses(jax_model, axes, tp)
        if refused:
            with pytest.raises(ValueError, match=f"% tp {tp} != 0"):
                check_tp_divisibility(port, tp)
        else:
            check_tp_divisibility(port, tp)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    return ranks.spawn(ranks.models_job, 2, str(tmp_path_factory.mktemp("models")))


@pytest.mark.parametrize("kind", list(ranks.TP_MODELS))
def test_tp_step_equals_one_process(spawned, kind):
    """Each rank's tp = 2 step (gathered) against one process's on the same
    global batch; the split and gathered tensors each held as a slice."""
    noisy, clean = ranks.global_batch()
    ref = ranks.one_step(ranks.tp_model(kind), noisy, clean, aux=ranks.TP_MODELS[kind][2])
    whole = dict(ranks.tp_model(kind).named_parameters())
    placements = param_shardings(ranks.tp_model(kind))
    n_placed = sum(pl is not None for pl in placements.values())
    assert n_placed == {"ablation": 46, "dncnn": 0, "flagship_subnets": 136,
                        "restormer": 16}[kind]
    for rank, res in enumerate(spawned):
        got = res[kind]
        assert abs(got["loss"] - ref["loss"]) <= 1e-4, (rank, got["loss"], ref["loss"])
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), atol=5e-5,
                                       rtol=1e-3, err_msg=f"rank {rank} grad {n}")
        # one Adam step of lr 1e-3 from equal parameters: within 1e-6 where
        # |g| > 1e-6, within 2e-3 elsewhere (test_torch_parallel_mesh.py)
        for n, p in ref["params"].items():
            gap = (got["params"][n] - p).abs()
            if n not in ref["grads"]:  # a buffer: unchanged
                assert float(gap.max()) == 0.0, (rank, n)
                continue
            steady = ref["grads"][n].abs() > 1e-6
            assert float(torch.where(steady, gap, 0.0).max()) <= 1e-6, (rank, n)
            assert float(gap.max()) <= 2e-3, (rank, n)
        for n, (m, v) in ref["moments"].items():
            gm, gv = got["moments"][n]
            np.testing.assert_allclose(gm.numpy(), m.numpy(), atol=5e-6, rtol=1e-3,
                                       err_msg=f"rank {rank} exp_avg {n}")
            np.testing.assert_allclose(gv.numpy(), v.numpy(), atol=1e-9, rtol=2e-3,
                                       err_msg=f"rank {rank} exp_avg_sq {n}")
        for n, pl in placements.items():
            held = int(np.prod(got["local_shapes"][n]))
            assert held == (whole[n].numel() // 2 if pl is not None else whole[n].numel()), n
