"""The ablation family on the diamond-12 and ring-8 windows against the JAX
package (its jnp path, which serves this family on every window): each
``one_graph_filter`` solver and ``multiscale_graph_filter`` at 16x16 with
JAX-``init`` parameters carried across by ``params_to_torch`` (μ, ρ, γ
raised so that every solver term shows), within ``atol=1e-3`` (the bar of
the flagship's other windows against JAX's jnp path). The routes: the
single-scale GTV+GLR solver's three matvecs go to K6a on these windows and
never to K9; the two-scale solvers' planes, under K1's cap, take K1 (one
call, with the window) and no K5 step. K6a's plain version against ``matvec_plain`` and K9's plain
version on cross-4, on every window ``matvec_plain`` against the operators
of ``ops/graph.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.ablations import MultiScaleGraphFilter as JaxMultiScale
from irdu_tpu.models.ablations import OneGraphFilter as JaxOneGraph
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.ops import fused_step, graph
from irdu_tpu_torch.ops.system_matvec import system_matvec_plain
from irdu_tpu_torch.ops.windows import CROSS4, WINDOWS
from irdu_tpu_torch.solvers import ablation_solvers, gtv_glr
from irdu_tpu_torch.utils.weights import params_to_torch

from test_torch_ablations import _loud

WINDOWS_OFF_CROSS4 = ("diamond12", "ring8")
SOLVERS = ("single", "single_split", "single_noGTV", "two_scale_nl")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(case, window):
    """(JAX model, the port's model) of ``case`` on ``window``."""
    if case == "multiscale_graph_filter":
        return (JaxMultiScale(ngraphs=4, window=window),
                registry.create_model("multiscale_graph_filter", ngraphs=4, window=window))
    return (JaxOneGraph(n_channels_hidden=12, solver=case, window=window),
            registry.create_model("one_graph_filter", n_channels_hidden=12, solver=case,
                                  window=window))


@pytest.mark.parametrize("window", WINDOWS_OFF_CROSS4)
@pytest.mark.parametrize("case", SOLVERS + ("multiscale_graph_filter",))
def test_ablation_window_matches_jax(case, window, monkeypatch):
    """The port's model on the window (the kernels' plain versions on the
    CPU) against JAX's forward with the same parameters, atol 1e-3; the
    matvecs take K6a (3 calls) and never K9, the two-scale solve K1 once
    and no K5 step; the solver moves its input."""
    rng = np.random.RandomState(len(case) + len(window))
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    jm, model = _models(case, window)
    params = jax.jit(jm.init)(jax.random.key(0, impl="rbg"), jnp.asarray(x))
    params = _loud(params, rng)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    params_to_torch(params, model)
    model.eval()
    calls = {"k6a": 0, "k1": 0}

    def refuse(name):
        def fn(*args, **kw):
            raise AssertionError(f"{name} was called on the {window} window")
        return fn

    def counted(key, real):
        def fn(*args, **kw):
            calls[key] += 1
            assert kw["deltas"] == WINDOWS[window]
            return real(*args, **kw)
        return fn

    monkeypatch.setattr(ablation_solvers, "matvec_plain",
                        counted("k6a", ablation_solvers.matvec_plain))
    monkeypatch.setattr(ablation_solvers, "gg_matvec_chw",
                        counted("k6a", ablation_solvers.gg_matvec_chw))
    monkeypatch.setattr(ablation_solvers, "fused_system_matvec", refuse("K9"))
    monkeypatch.setattr(ablation_solvers, "system_matvec_plain", refuse("K9's plain version"))
    monkeypatch.setattr(gtv_glr, "gg_unroll_chw", counted("k1", gtv_glr.gg_unroll_chw))
    monkeypatch.setattr(gtv_glr, "gg_fused_step_chw", refuse("K5"))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    assert calls["k6a"] == (3 if case in ("single", "single_split") else 0)
    two_scale = case in ("two_scale_nl", "multiscale_graph_filter")
    assert calls["k1"] == (1 if two_scale else 0)
    # the solver's terms show: μ, ρ at e^-30 give another output
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rpartition(".")[2] in ("muys00", "ro00", "muys01", "ro01"):
                p.fill_(-30.0)
        quiet = model(torch.from_numpy(x)).numpy()
    assert np.abs(quiet - out).max() > 1e-3


def _operands(g, f, h, w, window, seed, tables):
    rng = np.random.RandomState(seed)
    e = len(WINDOWS[window])
    x = torch.from_numpy(rng.randn(2, g * f, h, w).astype(np.float32))
    wl, wg = (torch.from_numpy(rng.rand(2, g, e, h, w).astype(np.float32)) for _ in range(2))
    tab = (lambda: torch.from_numpy(rng.randn(g, 4, f).astype(np.float32))) if tables else (
        lambda: None)
    pl, pg = tab(), tab()
    mu, ro = (torch.from_numpy(0.2 + rng.rand(g).astype(np.float32)) for _ in range(2))
    return x, wl, wg, pl, pg, mu, ro


@pytest.mark.parametrize("tables", [False, True], ids=["identity", "stencil"])
def test_k6a_plain_equals_k9_plain_on_cross4(tables):
    """K6a's plain route (what ``GTVGLRSingleScale`` calls off cross-4) is
    the system matvec K9 computes: on cross-4 both plain versions agree on
    the same operands (K9's channels-last layout, its per-channel μ, ρ and
    (4, C) rows), with the no-stats identity and with a stencil."""
    g, f, h, w = 2, 3, 9, 7
    x, wl, wg, pl, pg, mu, ro = _operands(g, f, h, w, "cross4", 3, tables)
    got = fused_step.gg_matvec_chw(x, wl, wg, pl, pg, mu, ro, n_graphs=g, deltas=CROSS4)

    def rows(tab):
        return None if tab is None else tab.permute(1, 0, 2).reshape(4, -1)

    want = system_matvec_plain(x.permute(0, 2, 3, 1).contiguous(),
                               *(t.permute(0, 3, 4, 1, 2) for t in (wl, wg)), rows(pl), rows(pg),
                               mu.repeat_interleave(f), ro.repeat_interleave(f), n_graphs=g)
    torch.testing.assert_close(got, want.permute(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", WINDOWS_OFF_CROSS4)
def test_k6a_plain_is_the_system_matvec_on_the_window(window):
    """On the window, K6a's CPU path is ``matvec_plain``: x + μ·GLR(x) +
    ρ·CᵀC x over the window's edges, as ``ops/graph.py`` builds them, with
    the identity stencil."""
    g, f, h, w = 2, 3, 10, 8
    x, wl, wg, pl, pg, mu, ro = _operands(g, f, h, w, window, 5, False)
    d = WINDOWS[window]
    got = fused_step.gg_matvec_chw(x, wl, wg, pl, pg, mu, ro, n_graphs=g, deltas=d)
    xv = x.reshape(2, g, f, h, w)

    def edges(t):
        return [t[:, :, k:k + 1] for k in range(t.shape[2])]

    want = (xv + mu.reshape(g, 1, 1, 1) * graph.glr_apply(xv, edges(wl), None, d)
            + ro.reshape(g, 1, 1, 1) * graph.gtv_apply(xv, edges(wg), None, d))
    torch.testing.assert_close(got, want.reshape(x.shape), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, fused_step.matvec_plain(x, wl, wg, pl, pg, mu, ro,
                                                            n_graphs=g, deltas=d))
