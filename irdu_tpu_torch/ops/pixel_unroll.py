"""K7: the whole pixel-family unroll, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_unroll.py:gg_pixel_unroll_chw``
(body ``_pixel_unroll_kernel``). Given the edge weights, the solve is
independent per (batch, graph, node-feature) plane. One scale, the family's
window (diamond-12 as configured; cross-4 and ring-8 too), 2 ADMM rounds × 2
CG steps:

  rhs₁ = ỹ + ρ·Qỹ                                       Q = CᵀC (GGTV)
  x = rhs₁;  u = rhs₁ − A·x;  x += α₀·u;  u = rhs₁ − A·x + β₁·u;  x += α₁·u
  rhs₂ = ỹ + ρ·Cᵀ(2·S_γ(Cx) − Cx)                        the ADMM re-threshold
  x = rhs₂;  u = rhs₂ − A·x;  x += α₂·u;  u = rhs₂ − A·x + β₃·u;  x += α₃·u
  A·x = x + ρ·Qx + μ·GLR(x)

The pixel family's quirks (``irdu_tpu/solvers/pixel_gtv.py:10-20``): μ and ρ
are raw values and γ = exp(gamma00); only β[1] and β[3] enter; the bias
entering this fixed unroll is 0, so the re-threshold's ε − bias is
2·S_γ(Cx) − Cx; round 2 restarts CG from the new RHS. The stencil (``stats``)
pads by reflection (edge excluded), the neighbour reads clamp, and the Cᵀ
scatter and the transposed stencil read zeros. ỹ is the un-tiled
(B, F, H, W) image: plane (g, f) reads its plane f, and the G-fold tiling is
never materialized. The output's channel is c = g·F + f.

On the card (``kernels/csrc/pixel_unroll.cu``): one persistent cooperative
launch of six phases separated by grid barriers (rhs₁; the CG step from
rhs₁; the CG step with β₁; the re-threshold; the CG step from rhs₂; the CG
step with β₃, which writes the output), each one pass over every (b, g,
tile) item with the padded tile of K5 (``kernels/csrc/padded_tile.cuh``):
the graph's weight tiles come into shared memory once for the item's F
planes, plane f + 1's x box comes by cp.async while plane f computes, and
the stage planes lie over boxes not clipped to the image. Only x, the RHS
and the CG update cross tile borders: three f32 scratch planes per channel
plane (``irdu_pixel_unroll_scratch_floats``), allocated here; a phase
never writes the plane it reads over a box. The arithmetic from ỹ to the
output is f32 with nothing rounded between the steps; the next item's
weights and first x box are staged while the current item finishes. The
tile follows the dtype (``K7_TILES``): 32×64 in bf16 (one CTA of 512
threads an SM) and 16×64 in f32, on every window. The whole solve needs
~732 f32 operations per pixel and plane on diamond-12 (each edge term once;
``pixel_unroll_ops_per_pixel``: 216 + 43·E for E edges), so with the data
moved once it is bound by operations (``chip_smoke.py`` reports both bounds
at the served shapes); the design reads each weight plane once per phase
(GTV in all six, GLR in the four CG phases) and its halo.

What the kernel takes: the cross-4, diamond-12 and ring-8 windows
(``WINDOW_CODES``) with the reflect stencil pad (the family's); stats
tables set to None (the no-stats core) go to the kernel as the identity
stencil (1, 0, 0, 0), which computes the same values exactly. The plain
version takes any window and pad.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.windows import (CODE_WINDOWS, DIAMOND12, WINDOW_CODES, window_code,
                                        window_radius)


def edge_ops(n_edges, gtv_stats=True, glr_stats=True):
    """f32 operations per pixel and plane of each operator on a window of E
    edges, each edge term counted once (an add, mul or compare 1, an FMA 2):
    the stencil 9; Q = CᵀC 9 + 3·E (w·w·(s_p − s_q)) + 2·E (the scatter's
    two sums) + 9; the re-threshold 9 + 8·E + 2·E + 9; GLR 9 + 2·E + 1 + 9;
    A·x Q + GLR + 3. On diamond-12 (E = 12): 78, 138, 43, 124. Without its
    stats table (``gtv_stats`` for Q and the re-threshold, ``glr_stats`` for
    GLR) an operator has no stencil and its transpose: 18 fewer."""
    q, glr = 18 * gtv_stats + 5 * n_edges, 18 * glr_stats + 1 + 2 * n_edges
    return dict(q=q, rethresh=18 * gtv_stats + 10 * n_edges, glr=glr, matvec=q + glr + 3)


def pixel_unroll_ops_per_pixel(n_edges=12, stats=True):
    """The whole unroll's f32 operations per pixel and plane: the two RHS
    builds Q + 2 and R + 2, four CG steps A·x each plus their updates 3, 5,
    3, 5 (216 + 43·E; 732 on diamond-12; 180 fewer without stats tables)."""
    ops = edge_ops(n_edges, stats, stats)
    return ops["q"] + 2 + ops["rethresh"] + 2 + 4 * ops["matvec"] + 16


# K7's tile of each dtype, as pixel_unroll.cu picks it: (rows, columns,
# threads, CTAs an SM). bf16 takes 32x64 tiles, the fastest of 16x64, 32x64
# and 32x64 of 256 threads on the card (PERF.md, K7's design note); f32 takes
# 16x64, as a 32x64 tile's f32 weights would not fit a CTA
K7_TILES = {torch.bfloat16: (32, 64, 512, 1), torch.float32: (16, 64, 256, 1)}
K7_HALO = 4  # the x box's rows on diamond-12 (2 + r); the stage planes have 1 + r rows


def k7_smem_bytes(dtype, window=WINDOW_CODES[DIAMOND12]):
    """The shared memory of one K7 CTA in ``dtype`` on ``window`` (its code;
    ``pixel_unroll.cu`` Layout): four f32 stage planes (S and A of GTV and
    GLR) over the tile + 1 + r rows and + hsc columns (1 + r rounded up to
    a multiple of 4); two x boxes over the tile + 2 + r rows and + one 16-byte chunk of
    columns, each as large as the larger of y's box and an f32 box; the E
    weights [e][cell] of both operators in the input's dtype; each part
    rounded up to 16 bytes; r the window's radius."""
    th, tw, _, _ = K7_TILES[dtype]
    esize = torch.tensor([], dtype=dtype).element_size()
    deltas = CODE_WINDOWS[window]
    hs = 1 + window_radius(deltas)
    n_p = (th + 2 * hs) * (tw + 2 * ((hs + 3) & ~3))

    def up16(n):
        return (n + 15) // 16 * 16

    def box(size):
        return up16(size * (th + 2 * (hs + 1)) * (tw + 2 * (16 // size)))

    return (up16(4 * 4 * n_p) + 2 * max(box(esize), box(4))
            + up16(esize * 2 * len(deltas) * n_p))


def pixel_unroll_scal(n_graphs, mu, ro, gamma, alphas, betas):
    """The (G, 9) f32 table [μ, ρ, γ, α₀, α₁, α₂, α₃, β₁, β₃]. alphas/betas:
    (4, G) CG tables; only β[1] and β[3] are used."""
    cols = [graph.at_least_f32(torch.as_tensor(v)).reshape(n_graphs)
            for v in (mu, ro, gamma, alphas[0], alphas[1], alphas[2], alphas[3],
                      betas[1], betas[3])]
    return torch.stack(cols, dim=1).contiguous()


def pixel_unroll_plain(y, w_gtv, w_glr, pgtv, pglr, scal, *, n_graphs,
                       deltas=DIAMOND12, stats_mode="reflect", remat=False):
    """The unroll in plain PyTorch, f32 compute (f64 for f64 inputs), output
    in y's dtype. ``remat``: each of JAX's segments (the first RHS, each CG
    round, the re-threshold's RHS) through ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the segment's inputs for the backward
    pass and recomputes the rest, as JAX's ``jax.checkpoint`` of each does."""
    b, f, h, w = y.shape
    g = n_graphs
    yv = graph.at_least_f32(y)[:, None]  # (B, 1, F, H, W): broadcast over the graphs
    wg = [graph.at_least_f32(w_gtv)[:, :, e:e + 1] for e in range(len(deltas))]
    wl = [graph.at_least_f32(w_glr)[:, :, e:e + 1] for e in range(len(deltas))]
    pg, pl = graph.stats_table_terms(pgtv), graph.stats_table_terms(pglr)
    mu, ro, gam, *rest = (graph.at_least_f32(scal[:, k]).reshape(g, 1, 1, 1)
                          for k in range(9))
    alpha, beta1, beta3 = rest[:4], rest[4], rest[5]

    def matvec(x):
        return (x + ro * graph.gtv_apply(x, wg, pg, deltas, stats_mode)
                + mu * graph.glr_apply(x, wl, pl, deltas, stats_mode))

    def cg_round(rhs, a0, bt, a1):
        upd = rhs - matvec(rhs)
        x = rhs + a0 * upd
        upd = rhs - matvec(x) + bt * upd
        return x + a1 * upd

    def first_rhs(yv):
        return yv + ro * graph.gtv_apply(yv, wg, pg, deltas, stats_mode)

    def rethresh_rhs(x):
        return yv + ro * graph.gtv_rethresh_apply(x, wg, pg, gam, deltas, stats_mode)

    def segment(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    rhs = segment(first_rhs, yv)
    x = segment(cg_round, rhs, alpha[0], beta1, alpha[1])
    rhs = segment(rethresh_rhs, x)
    x = segment(cg_round, rhs, alpha[2], beta3, alpha[3])
    return x.reshape(b, g * f, h, w).to(y.dtype)


def _check(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs, deltas):
    if y.dim() != 4:
        raise ValueError(f"y must be (B, F, H, W), got {tuple(y.shape)}")
    b, f, h, w = y.shape
    g, e = n_graphs, len(deltas)
    for name, t, shape in (("w_gtv", w_gtv, (b, g, e, h, w)), ("w_glr", w_glr, (b, g, e, h, w)),
                           ("scal", scal, (g, 9))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if (pgtv is None) != (pglr is None):
        raise ValueError("give both stats tables or neither")
    for t in (pgtv, pglr):
        if t is not None and tuple(t.shape) != (g, 4, f):
            raise ValueError(f"stats tables must be {(g, 4, f)}, got {tuple(t.shape)}")


def gg_pixel_unroll_chw(y, w_gtv, w_glr, pgtv, pglr, scal, *, n_graphs,
                        deltas=DIAMOND12, stats_mode="reflect"):
    """The whole pixel unroll: y (B, F, H, W) the un-tiled ỹ; w_gtv, w_glr
    (B, G, E, H, W); pgtv, pglr (G, 4, F) stats tables or both None; scal
    (G, 9) from ``pixel_unroll_scal``. Returns (B, G·F, H, W) in y's dtype,
    channel c = g·F + f.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (the cross-4, diamond-12 or ring-8 window, reflect pad; y and the
    weights contiguous, all f32 or all bf16; H, W ≥ 2; tables any float
    type, cast to f32) or raises."""
    refuse_grad("gg_pixel_unroll_chw", y, w_gtv, w_glr, pgtv, pglr, scal)
    _check(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs, deltas)
    if library.tracing():
        return _OP(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs, library.flat_deltas(deltas),
                   stats_mode)
    return _run(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs, deltas, stats_mode)


def _run(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs, deltas, stats_mode):
    """The untraced call: the plain version on the CPU, else the launch."""
    if y.device.type == "cpu":
        return pixel_unroll_plain(y, w_gtv, w_glr, pgtv, pglr, scal, n_graphs=n_graphs,
                                  deltas=deltas, stats_mode=stats_mode)
    win = window_code(deltas)
    if win is None or stats_mode != "reflect":
        raise ValueError(f"gg_pixel_unroll_chw: the kernel takes the cross-4, diamond-12 and "
                         f"ring-8 windows with the reflect stencil pad, not {deltas} with "
                         f"{stats_mode!r}")
    planes = (y, w_gtv, w_glr)
    if any(t.device != y.device or t.dtype != y.dtype or not t.is_contiguous()
           for t in planes) or y.device.type != "cuda":
        raise ValueError("gg_pixel_unroll_chw needs y and the two weight tensors "
                         "contiguous, on one CUDA device, of one dtype")
    b, f, h, w = y.shape
    g, dev = n_graphs, y.device
    if pgtv is None:  # the identity stencil: s = 1·v + 0·(…) is v exactly
        pgtv = pglr = torch.tensor([1.0, 0.0, 0.0, 0.0]).reshape(1, 4, 1).expand(g, 4, f)
    tabs = [t.to(device=dev, dtype=torch.float32).contiguous() for t in (pgtv, pglr)]
    sc = scal.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((b, g * f, h, w), dtype=y.dtype, device=dev)
    lib = kernel_library()
    scratch = torch.empty((b * g * f, lib.irdu_pixel_unroll_scratch_floats(h, w)),
                          dtype=torch.float32, device=dev)
    status = lib.irdu_pixel_unroll(
        y.data_ptr(), w_gtv.data_ptr(), w_glr.data_ptr(), tabs[0].data_ptr(),
        tabs[1].data_ptr(), sc.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        b, g, f, h, w, win, dtype_code(y.dtype), torch.cuda.current_stream(dev).cuda_stream)
    check_status("gg_pixel_unroll_chw", status)
    gg_pixel_unroll_chw.launches += 1
    return out


gg_pixel_unroll_chw.launches = 0
_OP = library.define(
    "gg_pixel_unroll_chw(Tensor y, Tensor w_gtv, Tensor w_glr, Tensor? pgtv, Tensor? pglr, "
    "Tensor scal, int n_graphs, int[] deltas, str stats_mode) -> Tensor",
    lambda *a: _run(*a[:7], library.window(a[7]), a[8]),
    lambda y, *a: y.new_empty((y.shape[0], a[5] * y.shape[1], *y.shape[2:])))
