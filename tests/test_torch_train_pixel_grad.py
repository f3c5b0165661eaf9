"""The port's pixel-family loss and its gradients against ONE
``jax.value_and_grad`` of the JAX package's ``flagship_loss`` on its pixel
model (``irdu_tpu/models/pixel.py``), on the narrow shapes JAX's pixel
fields allow: 4 graphs, 8 CNN features, feature blocks (1, 1, 1, 1), one
refinement block, a 32² batch of 2. The loss is the one its configs train
with: L1, no aux terms (``use_aux_losses: False``); JAX takes its jnp route
and the port its plain route, both under autograd.

The parameters are a seeded port model's, carried to JAX's tree by
``params_from_torch``. JAX's side is eager, not jitted: ``jax.jit`` of this
``value_and_grad`` compiles for tens of minutes on the CPU (the forward
alone for over a minute), where the eager gradient takes under a minute.
Against the same gradients: one Adam update against optax's."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irdu_tpu.models.pixel import MultiScaleSequenceDenoiser as JaxPixel
from irdu_tpu.train.steps import flagship_loss as jax_flagship_loss
from irdu_tpu.train.trainer import build_schedule as jax_build_schedule
from irdu_tpu_torch.data.synthetic import make_synthetic_image
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.models.registry import set_kernels
from irdu_tpu_torch.train.steps import apply_gradients, create_train_state, flagship_loss
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


PIXEL = dict(n_graphs=4, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
             feature_num_refinement=1)
B, SIDE = 2, 32
# the pixel config's schedule type, with lr(0) != lr(1): an update taking the
# wrong index shows
SCHEDULE = {"type": "multistep", "base_lr": 4e-4, "milestones": [1], "gamma": 0.5}


def _batch():
    rs = np.random.RandomState(2204)
    clean = np.stack([make_synthetic_image(rs, SIDE, SIDE) for _ in range(B)]) / np.float32(255)
    noisy = clean + rs.normal(0, 25 / 255, clean.shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _port_model(variables):
    model = MultiScaleSequenceDenoiser(**PIXEL)
    params_to_torch(variables, model)
    set_kernels(model, False)
    return model


@pytest.fixture(scope="module")
def ref():
    """The parameters and JAX's one value_and_grad."""
    noisy, clean = _batch()
    torch.manual_seed(0)
    variables = params_from_torch(MultiScaleSequenceDenoiser(**PIXEL))
    jm = JaxPixel(**PIXEL)

    def loss_fn(params):
        return jax_flagship_loss(jm, params, jnp.asarray(noisy), jnp.asarray(clean),
                                 jax.random.PRNGKey(0), use_aux_losses=False)

    (loss, denoised), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    return dict(noisy=noisy, clean=clean, variables=variables, loss=float(loss),
                denoised=np.asarray(denoised),
                grads=jax.tree_util.tree_map(lambda a: np.array(a, np.float32), grads))


@pytest.fixture(scope="module")
def port(ref):
    """The port's loss, denoised batch and gradients (in JAX's layouts: the
    grads put on a copy of the model and read back by ``params_from_torch``)."""
    model = _port_model(ref["variables"])
    assert model.mixtureGLR_block03.route() == "plain"
    loss, denoised = flagship_loss(model, torch.from_numpy(ref["noisy"]),
                                   torch.from_numpy(ref["clean"]), use_aux_losses=False)
    loss.backward()
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), model.parameters()):
            p.copy_(q.grad)
    return dict(loss=float(loss.detach()), denoised=denoised.detach().numpy(),
                grads=params_from_torch(holder)["params"])


def test_loss_matches_jax(ref, port):
    """The L1 loss, and the denoised batch."""
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    np.testing.assert_allclose(port["denoised"], ref["denoised"], atol=2e-5, rtol=1e-4)


def _scopes():
    """The flax scopes one level under the solver block, and the skip weight."""
    tree = params_from_torch(MultiScaleSequenceDenoiser(**PIXEL))["params"]
    return ([("mixtureGLR_block03", k) for k in sorted(tree["mixtureGLR_block03"])]
            + [(k,) for k in sorted(tree) if k != "mixtureGLR_block03"])


@pytest.mark.parametrize("scope", _scopes(), ids="/".join)
def test_gradients_match_jax(ref, port, scope):
    """Every gradient tensor under the flax scope ``scope``: atol 5e-5, rtol
    1e-3 (the flagship's rule); each non-zero where JAX's is."""
    ours, theirs = port["grads"], ref["grads"]["params"]
    for key in scope:
        ours, theirs = ours[key], theirs[key]
    ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    theirs = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert ours.keys() == theirs.keys() and theirs
    for path, g in theirs.items():
        np.testing.assert_allclose(ours[path], g, atol=5e-5, rtol=1e-3, err_msg=str(path))
        assert bool(np.any(ours[path] != 0)) == bool(np.any(g != 0)), path


def test_adam_update_matches_optax(ref):
    """One update from JAX's gradients: torch's Adam through
    ``apply_gradients`` against ``optax.adam`` on the same schedule, on the
    leaves concatenated into one vector (Adam is elementwise). optax rounds
    its bias correction in f32 where torch takes it in double: atol
    1e-5·lr."""
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
