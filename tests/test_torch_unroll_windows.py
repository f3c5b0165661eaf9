"""K1 (the whole solver unroll) on every option of the JAX package's K1: the
diamond-12 and ring-8 windows, the "zero" and "reflect" stencil pads and
stats tables set to None, against JAX's ``gg_unroll_chw`` in interpret mode
(16x128, 128-lane planes as tests/test_torch_solver_unroll.py builds them);
the CUDA kernel's tile scheme (its five phases through the tile step, a
4-pixel halo per scale) transliterated on those windows and pads against the
plain unroll, on ragged tiles; and the flagship solver's route: K1 under the
cap on every window, the band route above it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain
from irdu_tpu_torch.ops.windows import CROSS4, DIAMOND12, RING8, WINDOWS
from irdu_tpu_torch.solvers import gtv_glr
from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR
from test_torch_solver_unroll import G, _jax_unroll, _k1_scheme, _port

F = 3
C = G * F


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _softmax_weights(rng, h, w, n_e):
    z = rng.randn(1, G, n_e, h, w)
    e = np.exp(z - z.max(axis=2, keepdims=True))
    return (e / e.sum(axis=2, keepdims=True)).astype(np.float32)


def _inputs(h, w, deltas, seed, no_stats=False):
    """y, the four weight planes of the window, four tables (or None) and
    the (G, 10) scalars, μ, ρ, γ large enough that every term shows."""
    rng = np.random.RandomState(seed)
    n_e = len(deltas)
    y = (0.3 * rng.randn(1, C, h, w)).astype(np.float32)
    ws = [_softmax_weights(rng, h, w, n_e), _softmax_weights(rng, h, w, n_e),
          _softmax_weights(rng, h // 2, w // 2, n_e), _softmax_weights(rng, h // 2, w // 2, n_e)]
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    tables = [(inits + 0.3 * rng.randn(G, 4, F)).astype(np.float32) for _ in range(4)]
    scal = np.concatenate([
        np.exp(np.log([0.05, 0.1, 0.02, 0.05, 0.05, 0.05]) + 0.3 * rng.randn(G, 6)),
        0.5 + 0.1 * rng.randn(G, 3), 0.1 + 0.05 * rng.randn(G, 1)], axis=1).astype(np.float32)
    return y, ws, [None] * 4 if no_stats else tables, scal


def _torch(y, ws, tables, scal):
    """_inputs' arrays as tensors: y, the weight list, the table list, scal."""
    return (torch.from_numpy(y), [torch.from_numpy(a) for a in ws],
            [None if t is None else torch.from_numpy(t) for t in tables], torch.from_numpy(scal))


# (window, stats_mode, tables set to None)
OPTIONS = {"diamond12_edge": ("diamond12", "edge", False),
           "ring8_edge": ("ring8", "edge", False),
           "cross4_reflect": ("cross4", "reflect", False),
           "cross4_no_stats": ("cross4", "edge", True),
           "diamond12_zero": ("diamond12", "zero", False)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_k1_matches_jax_kernel(option):
    """The port's K1 wrapper (its plain version on the CPU, no launch)
    against JAX's K1 in interpret mode with the same window, pad and
    tables, at cg3."""
    window, pad, no_stats = OPTIONS[option]
    deltas = WINDOWS[window]
    y, ws, tables, scal = _inputs(16, 128, deltas, seed=len(option), no_stats=no_stats)
    ref = _jax_unroll(y, ws, tables, scal, 3, deltas=deltas, stats_mode=pad)
    before = gg_unroll_chw.launches
    ty, tws, ttabs, tscal = _torch(y, ws, tables, scal)
    out = gg_unroll_chw(ty, *tws, *ttabs, tscal, n_graphs=G, stats_mode=pad,
                        deltas=deltas).numpy()
    assert gg_unroll_chw.launches == before, "a CPU tensor must not launch"
    assert np.abs(ref - y).max() > 0.05  # the solve moved its input
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


# (window, stats_mode, tables set to None, tile)
SCHEMES = {"diamond12_edge_8x16": ("diamond12", "edge", False, (8, 16)),
           "diamond12_reflect_5x7": ("diamond12", "reflect", False, (5, 7)),
           "ring8_zero_5x7": ("ring8", "zero", False, (5, 7)),
           "cross4_reflect_no_stats_8x16": ("cross4", "reflect", True, (8, 16))}


@pytest.mark.parametrize("case", list(SCHEMES))
def test_kernel_tile_scheme_on_windows_and_pads(case):
    """The kernel's phases through the tile step on th x tw tiles of a 24x36
    plane (tiles on every edge, ragged last tiles, half tiles of odd size;
    on diamond-12 the halo of 4 is exactly what radius 2 needs) equal the
    plain unroll at cg3 on the window and pad."""
    window, pad, no_stats, (th, tw) = SCHEMES[case]
    deltas = WINDOWS[window]
    y, ws, tables, scal = _torch(*_inputs(24, 36, deltas, seed=len(case), no_stats=no_stats))
    if no_stats:  # the kernel's stand-in: the identity table
        ident = torch.zeros(G, 4, F)
        ident[:, 0] = 1.0
        tables = [ident] * 4
    out = _k1_scheme(y, ws, tables, scal, 3, th, tw, deltas=deltas, pad=pad)
    plain = gg_unroll_plain(y, *ws, *([None] * 4 if no_stats else tables), scal, n_graphs=G,
                            stats_mode=pad, deltas=deltas)
    assert (plain - y).abs().max() > 0.05  # the solve moved its input
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=5e-4, rtol=1e-3)


def test_k1_refuses_unbuilt_windows_and_short_reflect():
    """A window the kernels are not built for (JAX's kernel takes any
    offsets; the port's three windows are every window the models use) and
    a reflect pad on a plane whose half-res extent is under 2 (JAX's
    mirror row does not exist there either) raise ValueError."""
    y, ws, tables, scal = _torch(*_inputs(16, 32, CROSS4, seed=3))
    with pytest.raises(ValueError, match="window"):
        gg_unroll_chw(y, *ws, *tables, scal, n_graphs=G, deltas=CROSS4[:3])
    y, ws, tables, scal = _torch(*_inputs(2, 32, CROSS4, seed=3))
    with pytest.raises(ValueError, match="reflect"):
        gg_unroll_chw(y, *ws, *tables, scal, n_graphs=G, stats_mode="reflect")


def _pair(window, h, w, seed):
    """A MixtureGTVGLR on the window with seeded parameters (μ, ρ, γ raised so
    the solver terms show) and a seeded (1, h, w, C) input."""
    torch.manual_seed(seed)
    tm = MixtureGTVGLR(G, F, window=window)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn_like(p))
        for name in ("ro00", "ro01", "gamma00", "gamma01", "muys00", "muys01"):
            getattr(tm, name).add_(float(np.log(50.0)))
    x = (0.3 * np.random.RandomState(seed).randn(1, h, w, C)).astype(np.float32)
    return tm, x


@pytest.mark.parametrize("window", ["diamond12", "ring8"])
def test_route_under_the_cap_is_k1_on_every_window(monkeypatch, window):
    """Under the cap a plane of any window takes K1 (with the window) and no
    K5 step; with the cap at 0 it takes the band route's five K5 steps, and
    the two routes agree within the kernels' bar."""
    tm, x = _pair(window, 16, 32, seed=len(window))
    unrolls, steps = [], []

    def counted_unroll(*args, **kw):
        unrolls.append(kw["deltas"])
        return gg_unroll_chw(*args, **kw)

    def counted_step(*args, **kw):
        steps.append(kw["mode"])
        return gg_fused_step_chw(*args, **kw)

    monkeypatch.setattr(gtv_glr, "gg_unroll_chw", counted_unroll)
    monkeypatch.setattr(gtv_glr, "gg_fused_step_chw", counted_step)
    via_k1 = _port(tm, x)
    assert unrolls == [DIAMOND12 if window == "diamond12" else RING8] and not steps
    monkeypatch.setattr(gtv_glr, "_MEGA_MAX_PIXELS", 0)
    via_band = _port(tm, x)
    assert len(unrolls) == 1 and steps == ["rhs", "cg", "rethresh", "cg", "cg"]
    assert np.abs(via_k1 - x).max() > 0.05
    np.testing.assert_allclose(via_band, via_k1, atol=5e-4, rtol=1e-3)
