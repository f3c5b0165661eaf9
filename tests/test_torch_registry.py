"""Every ``configs/*.yaml`` model section through both registries: JAX's
``irdu_tpu.models.registry`` and the port's ``irdu_tpu_torch.models.registry``.

Where both build, JAX's parameter tree (shapes from ``jax.eval_shape`` of
``init`` at 16×16, zero-filled; with it the "spectral" collection's u
vectors) goes onto the port's model through ``params_to_torch``, which
raises on a name with no parameter or buffer, a parameter no name sets, or
a shape that differs. Where the port does not compute a value yet, it
raises ``NotImplementedError`` naming the field. Every field of each JAX
model's constructor is a parameter of the port's.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from irdu_tpu.models import registry as jax_registry
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.utils.weights import params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)[:-len(".yaml")]
                 for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))
# the configurations the port built last (GLR boosting, Restormer)
NEW_IN_PORT = {"glr_boosting", "restormer_sigma25"}
# the configurations of the options the port built last, as chip_smoke.py serves them
VARIANT_CONFIGS = ("flagship_sigma25_nonexpansive", "flagship_sigma25_spectral",
                   "lightformer_pixel_v4")


def _model_section(config):
    with open(os.path.join(REPO, "configs", f"{config}.yaml")) as fh:
        kw = dict(yaml.safe_load(fh)["model"])
    return kw.pop("type"), kw


def test_every_config_is_covered():
    """19 configurations, each with an expected outcome below."""
    assert len(CONFIGS) == 19
    assert NEW_IN_PORT | set(VARIANT_CONFIGS) <= set(CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_in_both_registries(config):
    """JAX builds every configuration, and the port builds it with JAX's
    parameter tree (the three of conv_variant and the v4 pixel core since
    they are ported, GLR boosting and Restormer since they are)."""
    name, kw = _model_section(config)
    jm = jax_registry.create_model(name, **kw)
    _builds_with_jax_tree(jm, registry.create_model(name, **kw))


def _builds_with_jax_tree(jax_model, port, hw=16):
    """JAX's variables at hw×hw, zero-filled, onto the port's model: every
    parameter set (to zero) and, with a "spectral" collection, every u
    vector set (to zero)."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, hw, hw, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params_to_torch(zeros, port)
    assert not any(p.detach().any() for p in port.parameters())
    assert ("spectral" in zeros) == any(n.endswith("kernel_u") for n, _ in port.named_buffers())
    assert not any(b.any() for n, b in port.named_buffers() if n.endswith("kernel_u"))


@pytest.mark.parametrize("model,field,value", [
    ("multiscale_sequence_denoiser", "n_cgd_iters", 3)])
def test_unported_field_values_name_the_field(model, field, value):
    """A value the port does not build raises NotImplementedError naming the
    field: here one JAX refuses too (``n_cgd_iters``)."""
    with pytest.raises(NotImplementedError, match=field):
        registry.create_model(model, **{field: value})


@pytest.mark.parametrize("model,field,value", [
    ("abstract_multiscale_graph_filter", "conv_variant", "spectral_norm"),
    ("abstract_multiscale_graph_filter", "conv_variant", "non_expansive"),
    ("multiscale_sequence_denoiser", "stats_mode", "none"),
    ("multiscale_sequence_denoiser", "feature_n_levels", 4),
    ("abstract_multiscale_graph_filter", "window", "diamond12"),
    ("multiscale_sequence_denoiser", "window", "cross4"),
    ("multiscale_sequence_denoiser", "eval_skip_solve", True),
    ("abstract_multiscale_graph_filter", "nsubnets", (2, 1, 1, 1))])
def test_ported_field_values_build_with_jax_tree(model, field, value):
    """The values the port computes since it took them (they named their
    field before): the model builds with JAX's parameter tree."""
    kw = {field: value}
    if model == "multiscale_sequence_denoiser":  # narrow, to keep JAX's shapes cheap
        kw.update(n_graphs=2, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
                  feature_num_refinement=1)
    _builds_with_jax_tree(jax_registry.create_model(model, **kw),
                          registry.create_model(model, **kw))


def test_chip_smoke_variant_dicts_equal_the_configs():
    """chip_smoke.py keeps the three configurations' ``model:`` sections
    itself (the card's machine has no PyYAML); they equal the files."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = {}
    for config in VARIANT_CONFIGS:
        with open(os.path.join(REPO, "configs", f"{config}.yaml")) as fh:
            want[config] = yaml.safe_load(fh)["model"]
    assert mod.VARIANT_MODELS == want


def test_pixel_inits_set_the_initial_parameters_as_jax():
    """``muy_init``, ``ro_init`` and ``gamma_init`` give the solver's μ, ρ
    and log γ JAX's initial values; the training flags build too."""
    kw = dict(n_graphs=2, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
              feature_num_refinement=1, muy_init=(0.3, 0.0, 0.0, 0.0),
              ro_init=(0.2, 0.0, 0.0, 0.0), gamma_init=(0.05, 0.0, 0.0, 0.0), remat=True,
              use_pallas_solver=True, use_nhwc_solver=True)
    jm = jax_registry.create_model("multiscale_sequence_denoiser", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    solver = params["mixtureGLR_block03"]
    port = registry.create_model("multiscale_sequence_denoiser", **kw).mixtureGLR_block03
    for name in ("muys00", "ro00", "gamma00"):
        np.testing.assert_allclose(getattr(port, name).detach().numpy(),
                                   np.asarray(solver[name]), rtol=1e-6)


@pytest.mark.parametrize("model", jax_registry.available_models())
def test_port_accepts_every_jax_field(model):
    """Each JAX model's constructor fields (flax dataclass fields, but flax's
    own ``parent`` and ``name``) are parameters of the port's constructor,
    with JAX's default where JAX has one."""
    jax_cls = jax_registry._REGISTRY[model]
    port = inspect.signature(registry._registry()[model]).parameters
    for f in dataclasses.fields(jax_cls):
        if f.name in ("parent", "name"):
            continue
        assert f.name in port, f"{model}: JAX field {f.name} missing"
        if f.default is not dataclasses.MISSING and not f.name.startswith("use_pallas"):
            want = f.default
            got = port[f.name].default
            assert (tuple(got) if isinstance(got, (list, tuple)) else got) == (
                tuple(want) if isinstance(want, (list, tuple)) else want), (model, f.name)
