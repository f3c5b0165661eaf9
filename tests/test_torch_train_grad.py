"""The port's flagship loss and its gradients against ONE ``jax.value_and_grad``
of the JAX package's ``flagship_loss``, on the tiny flagship of
``tests/test_trainer.py`` (dims 8/12/16/24, 32² patches, batch 2), computed
once in a module fixture: eager (no jit), about 100 s of op compiles and
runs on the CPU. The parameters are a seeded port model's, carried to JAX's
tree by ``params_from_torch`` (no JAX init to pay for); the latent noise is
drawn from JAX's split keys and passed to the port. Against the same
fixture: one Adam update from JAX's gradients against optax's, and the
distillation step: the teacher's forward (JAX's, computed inside the same
``value_and_grad`` as an auxiliary output behind ``stop_gradient``, where
its ops are the student's, already compiled) and the loss's composition.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.train.steps import flagship_loss as jax_flagship_loss
from irdu_tpu.train.trainer import build_schedule as jax_build_schedule
from irdu_tpu_torch.data.synthetic import make_synthetic_image
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.train.steps import (apply_gradients, create_train_state, flagship_loss,
                                        make_distill_train_step)
from irdu_tpu_torch.train.trainer import build_schedule
from irdu_tpu_torch.utils.weights import params_from_torch, params_to_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them about as fast,
    and the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(n_channels_in=3, n_channels_out=3, dims=(8, 12, 16, 24),
            hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4), num_blocks=(1, 1, 1, 1),
            num_blocks_out=1)
B, SIDE = 2, 32
# lr(0) != lr(1): an update taking the wrong index shows
SCHEDULE = {"type": "multistep", "base_lr": 4e-4, "milestones": [1], "gamma": 0.5}


def _batch():
    rs = np.random.RandomState(2204)
    clean = np.stack([make_synthetic_image(rs, SIDE, SIDE) for _ in range(B)]) / np.float32(255)
    noisy = clean + rs.normal(0, 25 / 255, clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def ref():
    """The parameters, JAX's latent draws, and the one value_and_grad (with
    the teacher's forward as an auxiliary output)."""
    noisy, clean = _batch()
    torch.manual_seed(0)
    variables = params_from_torch(AbstractMultiScaleGraphFilter(**TINY))
    teacher_vars = jax.tree_util.tree_map(lambda a: a * np.float32(0.9), variables)
    jm = JaxFlagship(**TINY)
    rng = jax.random.PRNGKey(1)
    codes = jax.eval_shape(lambda v: jm.apply(v, jnp.asarray(clean), method="encode"), variables)
    draws = [np.asarray(jax.random.normal(k, c.shape, c.dtype))
             for k, c in zip(jax.random.split(rng, len(codes)), codes)]

    def loss_fn(params):
        loss, denoised = jax_flagship_loss(jm, params, jnp.asarray(noisy), jnp.asarray(clean),
                                           rng)
        teacher = jax.lax.stop_gradient(jm.apply(teacher_vars, jnp.asarray(noisy)))
        return loss, (denoised, teacher)

    (loss, (denoised, teacher_out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables)
    return dict(noisy=noisy, clean=clean, variables=variables, teacher_vars=teacher_vars,
                teacher_out=np.asarray(teacher_out),
                noise=tuple(torch.from_numpy(d).permute(0, 3, 1, 2).contiguous() for d in draws),
                loss=float(loss), denoised=np.asarray(denoised), grads=_np_tree(grads))


def _port_model(variables):
    model = AbstractMultiScaleGraphFilter(**TINY)
    params_to_torch(variables, model)
    return model


def _grads_as_tree(model):
    """The parameters' .grad in JAX's layouts: the grads put on a copy of the
    model and read back with ``params_from_torch``."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), model.parameters()):
            p.copy_(q.grad)
    return params_from_torch(holder)["params"]


@pytest.fixture(scope="module")
def port(ref):
    model = _port_model(ref["variables"])
    loss, denoised = flagship_loss(model, torch.from_numpy(ref["noisy"]),
                                   torch.from_numpy(ref["clean"]), latent_noise=ref["noise"])
    loss.backward()
    return dict(loss=float(loss), denoised=denoised.detach().numpy(),
                grads=_grads_as_tree(model))


def test_loss_matches_jax(ref, port):
    """The 3-term loss (L1 + 0.1·MSE(recon) + 0.5·MSE(recon, disturbed)) with
    JAX's latent draws, and the denoised batch."""
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    np.testing.assert_allclose(port["denoised"], ref["denoised"], atol=2e-5, rtol=1e-4)


TOP_LEVEL = sorted(params_from_torch(AbstractMultiScaleGraphFilter(**TINY))["params"])


@pytest.mark.parametrize("scope", TOP_LEVEL)
def test_gradients_match_jax(ref, port, scope):
    """Every gradient tensor under the flax scope ``scope``, carried to JAX's
    layout by ``params_from_torch``: atol 5e-5, rtol 1e-3; each non-zero
    where JAX's is."""
    ours = dict(jax.tree_util.tree_flatten_with_path(port["grads"][scope])[0])
    theirs = dict(jax.tree_util.tree_flatten_with_path(ref["grads"]["params"][scope])[0])
    assert ours.keys() == theirs.keys()
    for path, g in theirs.items():
        np.testing.assert_allclose(ours[path], g, atol=5e-5, rtol=1e-3, err_msg=str(path))
        assert bool(np.any(ours[path] != 0)) == bool(np.any(g != 0)), path


def test_adam_update_matches_optax(ref):
    """One update from JAX's gradients: torch's Adam through
    ``apply_gradients`` (lr of update 0, eps 1e-8) against ``optax.adam`` on
    the same schedule. Adam is elementwise, so optax runs on the leaves
    concatenated into one vector (a few eager ops instead of a few per
    leaf). optax rounds its bias correction 1 - 0.999^t in f32 (1.3e-5 off
    at t = 1) where torch takes it in double, so the updates differ by up to
    ~7e-6 of their size: atol 1e-5·lr."""
    schedule = build_schedule(SCHEDULE)
    assert schedule(0) != schedule(1)
    tx = optax.adam(learning_rate=jax_build_schedule(SCHEDULE), eps=1e-8)
    params = ref["variables"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    flat = jnp.concatenate([jnp.ravel(a) for a in leaves])
    grads = jnp.concatenate([jnp.ravel(a) for a in jax.tree_util.tree_leaves(ref["grads"])])
    updates, _ = tx.update(grads, tx.init(flat), flat)
    new = np.asarray(optax.apply_updates(flat, updates))
    splits = np.cumsum([a.size for a in leaves])[:-1]
    want = jax.tree_util.tree_unflatten(
        tree, [v.reshape(a.shape) for v, a in zip(np.split(new, splits), leaves)])

    model = _port_model(params)
    grads = _port_model(ref["grads"])
    for p, g in zip(model.parameters(), grads.parameters()):
        p.grad = g.detach().clone()
    state = create_train_state(model, schedule)
    apply_gradients(state)
    assert state.step == 1
    got = params_from_torch(model)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5 * schedule(0), err_msg=str(path))
    assert any(np.any(a != b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                              jax.tree_util.tree_leaves(params)))


def test_distill_step_matches_jax_composition(ref):
    """The distillation step's loss is JAX's: the flagship loss plus
    L1(student, teacher(noisy)), the teacher frozen (a constant for autograd,
    its parameters untouched) and its forward JAX's (f32 here; bf16 on the
    card, through the kernels)."""
    jax_teacher = ref["teacher_out"]
    want = ref["loss"] + float(np.mean(np.abs(ref["denoised"] - jax_teacher)))

    teacher = _port_model(ref["teacher_vars"]).requires_grad_(False)
    before = [p.clone() for p in teacher.parameters()]
    with torch.inference_mode():
        np.testing.assert_allclose(teacher(torch.from_numpy(ref["noisy"])).numpy(), jax_teacher,
                                   atol=2e-5, rtol=1e-4)
    student = _port_model(ref["variables"])
    state = create_train_state(student, build_schedule(SCHEDULE))
    step = make_distill_train_step(teacher, distill_weight=1.0)
    _, metrics = step(state, torch.from_numpy(ref["noisy"]), torch.from_numpy(ref["clean"]),
                      latent_noise=ref["noise"])
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-5)
    assert all(torch.equal(a, b) and b.grad is None for a, b in zip(before, teacher.parameters()))
    assert state.step == 1
