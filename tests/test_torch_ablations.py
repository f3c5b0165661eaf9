"""The ablation family in the port against the JAX package: each
``one_graph_filter`` solver and ``multiscale_graph_filter`` against JAX's
forward (its jnp path) at 16x16 with JAX-``init`` parameters carried across
by ``params_to_torch`` (μ, ρ, γ raised so that every solver term shows), the
registry, the ablation model dicts that ``chip_smoke.py`` keeps against the
configs, and the flagship's parameter names under the solver's new options.
Tolerance: JAX's f32 kernel-vs-jnp bar, ``atol=5e-4, rtol=1e-3``."""

from __future__ import annotations

import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from irdu_tpu.models import registry as jax_registry
from irdu_tpu.models.ablations import MultiScaleGraphFilter as JaxMultiScale
from irdu_tpu.models.ablations import OneGraphFilter as JaxOneGraph
from irdu_tpu.solvers.gtv_glr import MixtureGTVGLR as JaxMixtureGTVGLR
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.ops.block_stack import fused_block_stack
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.gated_block import fused_gated_block
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
from irdu_tpu_torch.ops.system_matvec import fused_system_matvec
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR
from irdu_tpu_torch.utils.weights import params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = (fused_block_stack, fused_gated_block, edge_weights_chw, gg_unroll_chw,
           fused_system_matvec)
# log-parameters raised to these values, so that every solver term shows
LOUD = {"muys00": 0.5, "muys01": 0.3, "ro00": 0.5, "ro01": 0.3, "gamma00": 0.05,
        "gamma01": 0.05}


def _loud(params, rng):
    """JAX's init with μ, ρ, γ raised, α, β and the metric spread."""
    p = jax.tree_util.tree_map(np.array, params)
    lf = p["params"]["localfilter"]
    for name, v in LOUD.items():
        if name in lf:
            lf[name] = np.full_like(lf[name], np.log(v))
    lf["alphaCGD"] = (0.3 + 0.4 * rng.rand(*lf["alphaCGD"].shape)).astype(np.float32)
    lf["betaCGD"] = (0.1 + 0.2 * rng.rand(*lf["betaCGD"].shape)).astype(np.float32)
    for op in ("GTVmodule00", "GLRmodule00", "GTVmodule01", "GLRmodule01"):
        if op in lf:
            lf[op]["multiM"] = (0.5 + rng.rand(*lf[op]["multiM"].shape)).astype(np.float32)
    return p


CASES = {  # name: (JAX model, the port's create_model arguments)
    "single": (lambda: JaxOneGraph(n_channels_hidden=12, solver="single"),
               dict(name="one_graph_filter", n_channels_hidden=12, solver="single")),
    "single_split": (lambda: JaxOneGraph(n_channels_hidden=12, solver="single_split"),
                     dict(name="one_graph_filter", n_channels_hidden=12,
                          solver="single_split")),
    "single_noGTV": (lambda: JaxOneGraph(n_channels_hidden=12, solver="single_noGTV"),
                     dict(name="one_graph_filter", n_channels_hidden=12,
                          solver="single_noGTV")),
    "two_scale_nl": (lambda: JaxOneGraph(n_channels_hidden=12, solver="two_scale_nl"),
                     dict(name="one_graph_filter", n_channels_hidden=12,
                          solver="two_scale_nl")),
    "multiscale_graph_filter": (lambda: JaxMultiScale(ngraphs=4),
                                dict(name="multiscale_graph_filter", ngraphs=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ablation_matches_jax(case):
    jax_ctor, kw = CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    jm = jax_ctor()
    params = _loud(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    kw = dict(kw)
    model = registry.create_model(kw.pop("name"), **kw).eval()
    params_to_torch(params, model)  # raises on a leaf without a parameter, or the reverse
    counts = [k.launches for k in KERNELS]
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert [k.launches for k in KERNELS] == counts, "CPU tensors must not launch"
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    # the filter moves its input: the same model with the solver's terms off
    # (μ, ρ at e^-30) gives another output
    quiet = jax.tree_util.tree_map(np.array, params)
    for name in ("muys00", "ro00", "muys01", "ro01"):
        if name in quiet["params"]["localfilter"]:
            quiet["params"]["localfilter"][name][:] = -30.0
    assert np.abs(np.asarray(jm.apply(quiet, jnp.asarray(x))) - ref).max() > 1e-3


def test_kernel_route_matches_plain_route():
    """``use_kernels`` off runs the plain versions, the on-card reference of
    the kernel route; on the CPU both are the plain versions and agree."""
    model = registry.create_model("one_graph_filter", n_channels_hidden=12,
                                  solver="single").eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 16, 20, 3).astype(np.float32))
    with torch.no_grad():
        out = model(x)
        for m in model.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = False
        ref = model(x)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)


def test_registry_names_and_unported_models():
    """The port's registry has JAX's 16 names (none left unported): GLR
    boosting builds; a name neither has raises KeyError."""
    assert registry.available_models() == jax_registry.available_models()
    assert len(registry.available_models()) == 16
    assert type(registry.create_model("glr_boosting_pyramid")).__name__ == "GLRBoostingPyramid"
    with pytest.raises(KeyError, match="available"):
        registry.create_model("no_such_model")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("intervals,want", [
    ([(0, 10), (5, 15), (20, 30)], 25.0),   # overlapping, then disjoint
    ([(-5, 5), (95, 120)], 10.0),           # clipped to the window [0, 100]
    ([(10, 20), (12, 18), (40, 40)], 10.0),  # nested, and an empty one
    ([], 0.0)], ids=["overlap", "clipped", "nested", "none"])
def test_chip_smoke_busy_time_is_the_union_in_the_window(intervals, want):
    """The profile line's device busy time: the union of the device
    intervals inside the requests' window, each instant counted once."""
    assert _chip_smoke().busy_in_window(intervals, 0, 100) == want


def test_chip_smoke_ablation_dicts_equal_the_configs():
    """chip_smoke.py keeps the six ablation configs' ``model:`` sections
    itself (the card's machine has no PyYAML); they equal the files."""
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "ablation_*.yaml")))
    assert len(paths) == 6
    want = {}
    for p in paths:
        with open(p) as fh:
            want[os.path.basename(p)[:-len(".yaml")]] = yaml.safe_load(fh)["model"]
    assert _chip_smoke().ABLATION_MODELS == want


@pytest.mark.parametrize("config", sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(REPO, "configs", "ablation_*.yaml"))))
def test_config_builds_with_jax_parameter_count(config):
    """Each ablation config's model, built by the registry at its widths, has
    the JAX model's parameter count."""
    with open(os.path.join(REPO, "configs", f"{config}.yaml")) as fh:
        kw = dict(yaml.safe_load(fh)["model"])
    name = kw.pop("type")
    jm = jax_registry.create_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in registry.create_model(name, **kw).parameters()) == n_jax


def _flax_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_names(v, f"{prefix}{k}.")
        else:
            yield prefix + ("weight" if k == "kernel" else k)


@pytest.mark.parametrize("head", ["pointwise", "nonlinear3"])
def test_solver_parameter_names_match_jax(head):
    """The port's MixtureGTVGLR has JAX's parameter names: at the flagship's
    defaults (the pointwise heads) and with the nonlinear3 heads."""
    g, f = 2, 6
    jm = JaxMixtureGTVGLR(n_graphs=g, n_node_fts=f, feature_head=head)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, g * f))))
    port = MixtureGTVGLR(g, f, feature_head=head)
    assert sorted(n for n, _ in port.named_parameters()) == sorted(_flax_names(shapes["params"]))


@pytest.mark.parametrize("stats_mode", ["scalar", "none"])
def test_solver_stats_modes_match_jax(stats_mode):
    """MixtureGTVGLR with the stencil's other modes against JAX's jnp path:
    scalar coefficients, and no stencil (the identity table on K1's plain
    version); 1x16x16, G = 2, F = 3, μ, ρ, γ raised."""
    g, f = 2, 3
    rng = np.random.RandomState(7)
    x = rng.rand(1, 16, 16, g * f).astype(np.float32)
    jm = JaxMixtureGTVGLR(n_graphs=g, n_node_fts=f, stats_mode=stats_mode)
    params = _loud({"params": {"localfilter": jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
                               ["params"]}}, rng)["params"]["localfilter"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = MixtureGTVGLR(g, f, stats_mode=stats_mode).eval()
    params_to_torch({"params": params}, port)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert np.abs(ref - x).max() > 0.05
