"""K5 (``irdu_tpu_torch/ops/fused_step.py``) on every window the JAX package
sends it: one scale with the pixel family's reflect pad on cross-4 and
ring-8, two scales with the flagship's edge pad on diamond-12 and ring-8.
The plain version against JAX's ``gg_fused_step_chw`` in interpret mode
(``atol=5e-4, rtol=1e-3``, tests/test_solver_unroll.py:39-40), and the CUDA
kernel's padded tile, transliterated (tests/test_torch_fused_step.py
``padded_step``), against the plain version."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.ops.pallas.solver_chw import fused_scal as jax_fused_scal
from irdu_tpu.ops.pallas.solver_chw import gg_fused_step_chw as jax_step
from irdu_tpu_torch.ops import fused_step as fs
from irdu_tpu_torch.ops.windows import CROSS4, DIAMOND12, RING8
from test_torch_fused_step import padded_step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _softmax(rng, shape, axis):
    z = rng.randn(*shape)
    ex = np.exp(z - z.max(axis=axis, keepdims=True))
    return (ex / ex.sum(axis=axis, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# K5: one scale on cross-4 and ring-8 (reflect), two scales on diamond-12 and
# ring-8 (edge)
# ---------------------------------------------------------------------------

G5, F5 = 2, 3
K5_WINDOWS = {  # window, two scales, stencil pad
    "cross4_one_scale": (CROSS4, False, "reflect"),
    "ring8_one_scale": (RING8, False, "reflect"),
    "diamond12_two_scale": (DIAMOND12, True, "edge"),
    "ring8_two_scale": (RING8, True, "edge"),
}


def _k5_inputs(deltas, two, h, w, seed):
    """x, aux, prev (1, C, h, w); the weights of the window (the half-res
    pair None on one scale); four stats tables (the half-res pair None on
    one scale); the per-graph scalars, as the JAX tests draw them."""
    rng = np.random.RandomState(seed)
    e, c = len(deltas), G5 * F5
    planes = [(rng.randn(1, c, h, w) * s).astype(np.float32) for s in (1.0, 0.5, 0.5)]
    ws = [_softmax(rng, (1, G5, e, h, w), 2), _softmax(rng, (1, G5, e, h, w), 2)]
    ws += ([_softmax(rng, (1, G5, e, h // 2, w // 2), 2) for _ in range(2)] if two
           else [None, None])
    inits = np.array([1.0, 0.5, 0.5, 0.5], np.float32)[None, :, None]
    tables = [(inits + 0.3 * rng.randn(G5, 4, F5)).astype(np.float32) for _ in range(4)]
    if not two:
        tables[2:] = [None, None]

    def mk(lo):
        return (rng.rand(G5) + lo).astype(np.float32)

    s = dict(mu0=mk(0.1), ro0=mk(0.1), mu1=mk(0.05), ro1=mk(0.05), alpha=mk(0.2),
             beta=mk(0.1), gamma0=mk(0.05) * 0.5, gamma1=mk(0.05) * 0.5)
    return planes, ws, tables, s


K5_MODES = {"cg_prev_emit_update": ("cg", True, True, dict(emit_update=True)),
            "rethresh_y": ("rethresh", True, False, {})}  # mode, aux, prev, keywords


@pytest.mark.parametrize("mode_case", list(K5_MODES))
@pytest.mark.parametrize("case", list(K5_WINDOWS))
def test_fused_step_window_matches_jax_kernel(case, mode_case):
    """The port's K5 (the plain version on the CPU) against JAX's
    ``gg_fused_step_chw`` in interpret mode at the JAX tests' 32x24."""
    deltas, two, pad = K5_WINDOWS[case]
    mode, has_aux, has_prev, kw = K5_MODES[mode_case]
    (x, aux, prev), ws, tables, s = _k5_inputs(deltas, two, 32, 24, seed=len(case + mode_case))
    scal = np.asarray(jax_fused_scal(G5, **s))
    args = [x, aux if has_aux else None, prev if has_prev else None, *ws, *tables, scal]
    ref = jax_step(*map(_j, args), mode=mode, n_graphs=G5, true_h=32, true_w=24, deltas=deltas,
                   stats_mode=pad, interpret=True, **kw)
    before = fs.gg_fused_step_chw.launches
    out = fs.gg_fused_step_chw(*map(_t, args), mode=mode, n_graphs=G5, deltas=deltas,
                               stats_mode=pad, **kw)
    assert fs.gg_fused_step_chw.launches == before, "a CPU tensor must not launch"
    outs, refs = (out, ref) if kw else ((out,), (ref,))
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)
    base = aux if mode == "rethresh" else x
    assert np.abs(np.asarray(refs[0]) - base).max() > 0.05


@pytest.mark.parametrize("mode", ["rhs", "cg", "rethresh"])
@pytest.mark.parametrize("case,hw", [("cross4_one_scale", (37, 53)),
                                     ("ring8_one_scale", (21, 133)),
                                     ("diamond12_two_scale", (36, 70)),
                                     ("ring8_two_scale", (34, 134))])
def test_fused_step_window_padded_tile_matches_plain(case, hw, mode):
    """K5's padded tile (fused_step_hopper.cu, ``k5_tile``: 16x64 on one
    scale, two-scale 16x32 on diamond-12 and 16x64 on ring-8) on the window
    over ragged tiles on every image edge: the plain step's result, and no
    cell the kernel leaves uncomputed is read."""
    deltas, two, pad = K5_WINDOWS[case]
    (x, aux, prev), ws, tables, s = _k5_inputs(deltas, two, *hw, seed=sum(hw))
    x, aux, prev = map(_t, (x, aux, prev))
    ws, tables = [_t(a) for a in ws], [_t(a) for a in tables]
    scal = fs.fused_scal(G5, **{k: _t(v) for k, v in s.items()})
    aux_m = None if mode == "rhs" else aux
    prev_m = prev if mode == "cg" else None
    tabs = [fs.identity_table(G5, F5) if t is None else t for t in tables]
    out, upd = padded_step(x, aux_m, prev_m, ws, tabs, scal, mode, G5, deltas=deltas,
                           reflect=pad == "reflect")
    want = fs.fused_step_plain(x, aux_m, prev_m, *ws, *tables, scal, mode=mode, n_graphs=G5,
                               deltas=deltas, stats_mode=pad, emit_update=mode == "cg")
    if mode == "cg":
        torch.testing.assert_close(upd, want[1], atol=5e-4, rtol=1e-3)
        want = want[0]
    torch.testing.assert_close(out, want, atol=5e-4, rtol=1e-3)
