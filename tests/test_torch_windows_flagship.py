"""The flagship on the diamond-12 and ring-8 windows against the JAX package
(its jnp path: JAX's ``_chw_ok`` sends every window but cross-4 there), the
route rule (a plane under the cap takes K1 on every window, as on cross-4),
K1 on another window against its plain version, the ``nsubnets`` values
still refused (those that do not split a width) and ``registry.require``'s
two messages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.models.registry import create_model, require
from irdu_tpu_torch.ops import solver_unroll
from irdu_tpu_torch.ops.windows import DIAMOND12, RING8
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.utils.weights import params_to_torch
from test_torch_solver_unroll import _jax_unroll

# tests/test_deploy.py's TINY flagship
TINY = dict(dims=(8, 12, 16, 24), hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4),
            num_blocks=(1, 1, 1, 1), num_blocks_out=1)
SIDE = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_params():
    """JAX's TINY flagship's init (its parameters do not depend on the
    window), with every solver's μ, ρ and γ raised to U(0.2, 0.4) so that
    the window's edge terms show in the output; a seeded 1x32x32x3 image."""
    x = np.random.RandomState(0).rand(1, SIDE, SIDE, 3).astype(np.float32)
    key = jax.random.key(0, impl="rbg")
    params = jax.jit(JaxFlagship(**TINY).init)(key, jnp.zeros_like(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    for s in range(4):
        lf = params["params"][f"localfilter_scale_{s:02d}"]["local_filter"]
        for name in ("muys00", "muys01", "ro00", "ro01", "gamma00", "gamma01"):
            lf[name] = np.log(0.2 + 0.2 * rng.rand(*lf[name].shape)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("window", ["diamond12", "ring8"])
def test_flagship_window_matches_jax_and_takes_the_band_route(tiny_params, window,
                                                              monkeypatch):
    """The port's flagship on the window (the kernels' plain versions on the
    CPU) against JAX's jnp path with the same parameters, atol 1e-3; every
    filtering block's plane is under the cap, so each solves on K1 with the
    window, one call a block, and no K5 step is made (the band route takes
    the planes above the cap, tests/test_torch_unroll_windows.py)."""
    params, x = tiny_params
    ref = np.asarray(JaxFlagship(**TINY, window=window).apply(params, jnp.asarray(x)))
    model = create_model("abstract_multiscale_graph_filter", **TINY, window=window)
    params_to_torch(params, model)
    model.eval()
    unrolls = []

    def no_step(*args, **kw):
        raise AssertionError("a plane under the cap reached the band route")

    def counted_unroll(*args, **kw):
        unrolls.append(kw["deltas"])
        return real_unroll(*args, **kw)

    real_unroll = gtv_glr.gg_unroll_chw
    monkeypatch.setattr(gtv_glr, "gg_unroll_chw", counted_unroll)
    monkeypatch.setattr(gtv_glr, "gg_fused_step_chw", no_step)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    want = DIAMOND12 if window == "diamond12" else RING8
    assert unrolls == [want] * 4
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    assert np.abs(ref - x).max() > 0.05


@pytest.mark.parametrize("window", ["diamond12", "ring8"])
def test_k1_refuses_another_window(window):
    """K1 takes every window now: its wrapper on the window (the plain
    version on the CPU) agrees with JAX's K1 in interpret mode on the same
    8x8 planes (lane-padded for JAX), at atol 5e-4, rtol 1e-3 (the options
    at 16x128: tests/test_torch_unroll_windows.py)."""
    g, f, h, w = 2, 3, 8, 8
    deltas = DIAMOND12 if window == "diamond12" else RING8
    n_e = len(deltas)
    rng = np.random.RandomState(n_e)
    y = (0.3 * rng.randn(1, g * f, h, w)).astype(np.float32)
    ws = []
    for s in (h, h, h // 2, h // 2):
        z = np.exp(rng.randn(1, g, n_e, s, s))
        ws.append((z / z.sum(axis=2, keepdims=True)).astype(np.float32))
    tab = (np.array([1.0, 0.5, 0.5, 0.5])[None, :, None]
           + 0.3 * rng.randn(g, 4, f)).astype(np.float32)
    scal = (0.1 + 0.4 * rng.rand(g, 10)).astype(np.float32)
    out = solver_unroll.gg_unroll_chw(
        *(torch.from_numpy(a) for a in (y, *ws, tab, tab, tab, tab, scal)), n_graphs=g,
        deltas=deltas).numpy()
    ref = _jax_unroll(y, ws, [tab] * 4, scal, 3, deltas=deltas)
    assert np.abs(ref - y).max() > 0.05
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


def test_flagship_still_refuses_nsubnets():
    """``nsubnets > 1`` is ported (tests/test_torch_subnets.py); what is
    still refused is a subnet count that does not split a scale's widths
    (JAX's grouped kernels cannot be reshaped there either), with a
    ValueError naming the field."""
    AbstractMultiScaleGraphFilter(**TINY, nsubnets=(2, 1, 1, 1))
    with pytest.raises(ValueError, match="nsubnets"):
        AbstractMultiScaleGraphFilter(**TINY, nsubnets=(3, 1, 1, 1))


@pytest.mark.parametrize("jax_refuses", [False, True], ids=["not_ported", "jax_refuses"])
def test_require_tells_not_ported_from_jax_refuses(jax_refuses):
    """``registry.require``: a value the port has not ported yet, or one JAX
    refuses too (with its reason)."""
    reason = "the reference unroll is fixed at 4 CG iterations" if jax_refuses else None
    require("field", 4, [4], reason)
    with pytest.raises(NotImplementedError) as err:
        require("field", 3, [4], reason)
    msg = str(err.value)
    assert ("JAX refuses it too" in msg and reason in msg) == jax_refuses
    assert ("not ported yet" in msg) != jax_refuses
