"""Every ``configs/*.yaml`` model section through both registries: JAX's
``irdu_tpu.models.registry`` and the port's ``irdu_tpu_torch.models.registry``.

Where both build, JAX's parameter tree (shapes from ``jax.eval_shape`` of
``init`` at 16×16, zero-filled) goes onto the port's model through
``params_to_torch``, which raises on a name with no parameter, a parameter
no name sets, or a shape that differs. Where the port does not compute a
value yet, it raises ``NotImplementedError`` naming the field; the models it
does not have (GLR boosting, Restormer) raise ``KeyError``.
"""

from __future__ import annotations

import glob
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
# the field the port names for a configuration it does not build yet
NOT_PORTED = {"flagship_sigma25_nonexpansive": "conv_variant",
              "flagship_sigma25_spectral": "conv_variant",
              "lightformer_pixel_v4": "stats_mode"}
NOT_IN_PORT = {"glr_boosting", "restormer_sigma25"}  # KeyError


def _model_section(config):
    with open(os.path.join(REPO, "configs", f"{config}.yaml")) as fh:
        kw = dict(yaml.safe_load(fh)["model"])
    return kw.pop("type"), kw


def test_every_config_is_covered():
    """19 configurations, each with an expected outcome below."""
    assert len(CONFIGS) == 19
    assert set(NOT_PORTED) | NOT_IN_PORT <= set(CONFIGS)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_builds_in_both_registries(config):
    """JAX builds every configuration. The port builds it with JAX's
    parameter tree, or names the field it does not compute yet, or does not
    have the model at all."""
    name, kw = _model_section(config)
    jm = jax_registry.create_model(name, **kw)
    if config in NOT_IN_PORT:
        with pytest.raises(KeyError, match="available"):
            registry.create_model(name, **kw)
        return
    if config in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=NOT_PORTED[config]):
            registry.create_model(name, **kw)
        return
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = registry.create_model(name, **kw)
    params_to_torch(zeros, port)
    assert not any(p.detach().any() for p in port.parameters())


@pytest.mark.parametrize("model,field,value", [
    ("abstract_multiscale_graph_filter", "nsubnets", (2, 1, 1, 1)),
    ("abstract_multiscale_graph_filter", "window", "diamond12"),
    ("abstract_multiscale_graph_filter", "conv_variant", "spectral_norm"),
    ("multiscale_sequence_denoiser", "window", "cross4"),
    ("multiscale_sequence_denoiser", "stats_mode", "none"),
    ("multiscale_sequence_denoiser", "feature_n_levels", 4),
    ("multiscale_sequence_denoiser", "n_cgd_iters", 3),
    ("multiscale_sequence_denoiser", "eval_skip_solve", True)])
def test_unported_field_values_name_the_field(model, field, value):
    """A value JAX supports and the port does not yet raises
    NotImplementedError naming the field."""
    with pytest.raises(NotImplementedError, match=field):
        registry.create_model(model, **{field: value})


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
