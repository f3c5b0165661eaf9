"""K1: the whole two-scale GGTV+GGLR ADMM/CG unroll of one flagship
filtering block, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_unroll.py:gg_unroll_chw``
(body ``_unroll_kernel``, plane helpers in ``solver_chw.py``). Given the edge
weights, the solve is independent per (batch, graph, node-feature) plane:

  rhs_a = y + ρ₀·Q₀y + Up(ρ₁·Q₁·Dn y)                        Q = CᵀC (GGTV)
  x₁    = rhs_a + α₀·(rhs_a − A·rhs_a)                        CG step 1
  rhs_b = y + ρ₀·Cᵀ₀(2S_γ₀(C₀x₁)−C₀x₁) + Up(ρ₁·Cᵀ₁(2S_γ₁(C₁Dn x₁)−C₁Dn x₁))
  u₁    = rhs_b − A·x₁;        x₂ = x₁ + α₁·u₁                CG step 2
  u₂    = rhs_b − A·x₂ + β₂·u₁; x₃ = x₂ + α₂·u₂               CG step 3
  A·x   = x + μ₀GLR₀x + ρ₀Q₀x + Up(μ₁GLR₁ + ρ₁Q₁)Dn x

with Dn the 2×2 box mean and Up its adjoint (duplicate and scale by 0.25).
Quirks kept from the reference: only β[2] is used; rhs_b serves CG steps 2
and 3; the stencil pads "edge", the Cᵀ scatter and the transposed stencil
pad with zeros, and every derived plane replicates its own edge row.
``eval_cg_iters`` stops after 1, 2 or 3 CG steps.

The options are JAX's: the graph window ``deltas`` (cross-4, diamond-12 or
ring-8: E edge-weight planes a scale, E = len(deltas)), the stencil's pad
``stats_mode`` ("edge", "zero" or "reflect": numpy's reflect without the
edge pixel; the graph shifts keep replicate, the scatter and the transposed
stencil zeros) and tables set to None (no stencil: the identity table
``ops/fused_step.identity_table``, which is exact, goes to the kernel).
JAX's ``true_w`` is its 128-lane padding of narrow planes, a TPU layout
fact, and is not copied: the port's planes are never padded.

On the card (``kernels/csrc/gg_unroll.cu``): one persistent cooperative
launch per call that runs the unroll as the phases of the band route (rhs_a;
CG step 1; the re-threshold to rhs_b; CG step 2, emitting u₁; CG step 3 on
x₂ = x₁ + α₁u₁ formed as it is read), each one pass over every 32×64 output
tile with a 4-pixel halo of every (b, g, f) plane, with the tile step of
``kernels/csrc/tile_step.cuh`` and every stage plane in shared memory.
The halo holds on every window: a wrong value at an interior region edge
moves inward by 1 (stencil) + r (the edge sums, r the window's radius: 1 on
cross-4 and ring-8, 2 on diamond-12) + 1 (stencilᵀ) ≤ 4 pixels, at both
scales. The window is a template argument (one instance file each:
``gg_unroll.cu`` cross-4, ``gg_unroll_diamond12.cu``,
``gg_unroll_ring8.cu``); on each window one instance fixes the pad to
"edge", the one every model sends (reading it at run time made the cross-4
K1 4.5 % slower on an H100), and a second reads the other pads at run time.
Between the phases only x, rhs_b and u cross tile borders: three f32
scratch planes per channel plane, allocated here; nothing is rounded between
the CG steps (the band route rounds each step's output to y's dtype). A
grid barrier separates the phases; the grid is two 256-thread CTAs per SM,
each looping over (plane, tile) items. The whole solve needs ~400 f32
operations per full-res pixel on cross-4 (each edge term once; about 1.9×
that on diamond-12 and 1.45× on ring-8; ~220 with the tables None, which
need no stencil, though the kernel runs the identity's), so with the
data moved once it is bound by operations; the halo recompute (1.4× at full
res, 1.9× at half res) and the phases' scratch traffic are what the design
pays for filling every SM.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.fused_step import identity_table
from irdu_tpu_torch.ops.graph import box_down2x2, box_up2x2
from irdu_tpu_torch.ops.windows import CODE_WINDOWS, CROSS4, window_code

STATS_PADS = ("edge", "zero", "reflect")  # JAX's stats_mode values; their codes in gg_unroll.cu


def unroll_scal(n_graphs, mu0, ro0, mu1, ro1, gamma0, gamma1, alphas, betas):
    """The (G, 10) f32 scalar table [μ₀, ρ₀, μ₁, ρ₁, γ₀, γ₁, α₀, α₁, α₂, β₂].
    alphas/betas: (3, G) CG tables; only β[2] is used."""
    cols = [torch.as_tensor(v).float().reshape(n_graphs)
            for v in (mu0, ro0, mu1, ro1, gamma0, gamma1,
                      alphas[0], alphas[1], alphas[2], betas[2])]
    return torch.stack(cols, dim=1).contiguous()


def gg_unroll_plain(y, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0,
                    pgtv1, pglr1, scal, *, n_graphs, eval_cg_iters=3,
                    stats_mode="edge", deltas=CROSS4):
    """The unroll in plain PyTorch, f32 compute, output in y's dtype; a
    table set to None is no stencil."""
    b, c, h, wd = y.shape
    g = n_graphs
    f = c // g
    n_e = len(deltas)
    yv = y.float().reshape(b, g, f, h, wd)

    def weights(wt):  # (B, G, E, h, w) → E × (B, G, 1, h, w)
        wt = wt.float()
        return [wt[:, :, e:e + 1] for e in range(n_e)]

    wg0, wl0, wg1, wl1 = (weights(t) for t in (w_gtv0, w_glr0, w_gtv1, w_glr1))
    pg0, pl0, pg1, pl1 = (graph.stats_table_terms(t) for t in (pgtv0, pglr0, pgtv1, pglr1))

    def col(k):  # per-graph scalar → (G, 1, 1, 1)
        return scal[:, k].float().reshape(g, 1, 1, 1)

    mu0, ro0, mu1, ro1, gam0, gam1 = (col(k) for k in range(6))
    alpha = [col(6 + i) for i in range(3)]
    beta2 = col(9)
    kw = dict(deltas=deltas, pad_mode=stats_mode)

    def matvec(x):
        xd = box_down2x2(x)
        t0 = ro0 * graph.gtv_apply(x, wg0, pg0, **kw) + mu0 * graph.glr_apply(x, wl0, pl0, **kw)
        t1 = (ro1 * graph.gtv_apply(xd, wg1, pg1, **kw)
              + mu1 * graph.glr_apply(xd, wl1, pl1, **kw))
        return x + t0 + box_up2x2(t1)

    rhs_a = (yv + ro0 * graph.gtv_apply(yv, wg0, pg0, **kw)
             + box_up2x2(ro1 * graph.gtv_apply(box_down2x2(yv), wg1, pg1, **kw)))
    x = rhs_a + alpha[0] * (rhs_a - matvec(rhs_a))
    if eval_cg_iters >= 2:
        rhs_b = (yv + ro0 * graph.gtv_rethresh_apply(x, wg0, pg0, gam0, **kw)
                 + box_up2x2(ro1 * graph.gtv_rethresh_apply(box_down2x2(x), wg1, pg1, gam1,
                                                            **kw)))
        upd1 = rhs_b - matvec(x)
        x = x + alpha[1] * upd1
        if eval_cg_iters >= 3:
            upd2 = rhs_b - matvec(x) + beta2 * upd1
            x = x + alpha[2] * upd2
    return x.reshape(b, c, h, wd).to(y.dtype)


def _check(y, w_gtv0, w_glr0, w_gtv1, w_glr1, tables, scal, n_graphs,
           eval_cg_iters, stats_mode, deltas):
    if window_code(deltas) is None:
        raise ValueError(f"gg_unroll_chw takes the cross-4, diamond-12 and ring-8 windows, "
                         f"not {deltas}")
    if stats_mode not in STATS_PADS:
        raise ValueError(f"stats_mode must be one of {STATS_PADS}, got {stats_mode!r}")
    if eval_cg_iters not in (1, 2, 3):
        raise ValueError(f"eval_cg_iters must be 1, 2 or 3, got {eval_cg_iters}")
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    b, c, h, w = y.shape
    g = n_graphs
    if c % g or h % 2 or w % 2:
        raise ValueError(f"y {tuple(y.shape)}: C must split into {g} graphs "
                         "and H, W must be even")
    if stats_mode == "reflect" and min(h, w) < 4:
        raise ValueError(f"the reflect pad needs H, W >= 4 (2 at half res), got {h}x{w}")
    f = c // g
    n_e = len(deltas)
    for name, t, shape in (("w_gtv0", w_gtv0, (b, g, n_e, h, w)),
                           ("w_glr0", w_glr0, (b, g, n_e, h, w)),
                           ("w_gtv1", w_gtv1, (b, g, n_e, h // 2, w // 2)),
                           ("w_glr1", w_glr1, (b, g, n_e, h // 2, w // 2)),
                           ("scal", scal, (g, 10))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in tables:
        if t is not None and tuple(t.shape) != (g, 4, f):
            raise ValueError(f"stats tables must be {(g, 4, f)}, got {tuple(t.shape)}")


def gg_unroll_chw(y, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0, pgtv1,
                  pglr1, scal, *, n_graphs, eval_cg_iters=3, stats_mode="edge",
                  deltas=CROSS4):
    """The whole unroll: y (B, C, H, W) with C = G·F; w_*0 (B, G, E, H, W);
    w_*1 (B, G, E, H/2, W/2), E the edges of the window ``deltas``
    (cross-4, diamond-12 or ring-8); p* (G, 4, F) stats tables or None (no
    stencil); ``stats_mode`` the stencil's pad ("edge", "zero", "reflect");
    scal (G, 10) from ``unroll_scal``. Returns (B, C, H, W) in y's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (y and the weights contiguous and all f32 or all bf16; tables any float
    type, cast to f32, a missing one the identity table)."""
    refuse_grad("gg_unroll_chw", y, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0, pgtv1,
                pglr1, scal)
    tables = (pgtv0, pglr0, pgtv1, pglr1)
    _check(y, w_gtv0, w_glr0, w_gtv1, w_glr1, tables, scal, n_graphs,
           eval_cg_iters, stats_mode, deltas)
    codes = (STATS_PADS.index(stats_mode), window_code(deltas))
    if library.tracing():  # the operator takes tables: a missing stencil is the identity
        return _OP(y, w_gtv0, w_glr0, w_gtv1, w_glr1, *_filled(tables, n_graphs, y), scal,
                   n_graphs, eval_cg_iters, *codes)
    return _run(y, w_gtv0, w_glr0, w_gtv1, w_glr1, *tables, scal, n_graphs, eval_cg_iters,
                *codes)


def _filled(tables, n_graphs, y):
    """The tables, each set to None replaced by the identity stencil's
    (``fused_step.identity_table``: p01·x + 0 is x exactly)."""
    return tuple(identity_table(n_graphs, y.shape[1] // n_graphs, y.device) if t is None
                 else t for t in tables)


def _run(y, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0, pgtv1, pglr1, scal, n_graphs,
         eval_cg_iters, pad=0, window=0):
    """The untraced call: the plain version on the CPU, else the launch.
    ``pad`` and ``window`` are codes: STATS_PADS' index, ``WINDOW_CODES``."""
    tables = (pgtv0, pglr0, pgtv1, pglr1)
    if y.device.type == "cpu":
        return gg_unroll_plain(y, w_gtv0, w_glr0, w_gtv1, w_glr1, *tables, scal,
                               n_graphs=n_graphs, eval_cg_iters=eval_cg_iters,
                               stats_mode=STATS_PADS[pad], deltas=CODE_WINDOWS[window])
    planes = (y, w_gtv0, w_glr0, w_gtv1, w_glr1)
    if any(t.device != y.device or t.dtype != y.dtype or not t.is_contiguous()
           for t in planes) or y.device.type != "cuda":
        raise ValueError("gg_unroll_chw needs y and the four weight tensors "
                         "contiguous, on one CUDA device, of one dtype")
    b, c, h, w = y.shape
    dev = y.device
    tabs = [t.to(device=dev, dtype=torch.float32).contiguous()
            for t in _filled(tables, n_graphs, y)]
    sc = scal.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(y)
    lib = kernel_library()
    scratch = torch.empty((b * c, lib.irdu_gg_unroll_scratch_floats(h, w)),
                          dtype=torch.float32, device=dev)  # X, R, U
    status = lib.irdu_gg_unroll(
        y.data_ptr(), w_gtv0.data_ptr(), w_glr0.data_ptr(), w_gtv1.data_ptr(),
        w_glr1.data_ptr(), *(t.data_ptr() for t in tabs), sc.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, n_graphs, c // n_graphs, h, w,
        eval_cg_iters, window, pad, dtype_code(y.dtype),
        torch.cuda.current_stream(dev).cuda_stream)
    check_status("gg_unroll_chw", status)
    gg_unroll_chw.launches += 1
    return out


gg_unroll_chw.launches = 0
_OP = library.define(
    "gg_unroll_chw(Tensor y, Tensor w_gtv0, Tensor w_glr0, Tensor w_gtv1, Tensor w_glr1, "
    "Tensor pgtv0, Tensor pglr0, Tensor pgtv1, Tensor pglr1, Tensor scal, int n_graphs, "
    "int eval_cg_iters, int pad, int window) -> Tensor", _run,
    lambda y, *rest: y.new_empty(y.shape))
