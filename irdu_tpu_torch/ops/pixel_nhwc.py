"""K8: one fused segment of the pixel-family unroll, channels-last, and the
6-segment unroll built from it.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/pixel_nhwc.py:pixel_segment_nhwc``
(body ``_kernel``), driven by ``pixel_unroll_nhwc``. Layouts:

  x, aux, prev, out, upd  (B, H, W, C = F·G), planar channel order c = f·G + g
  w_gtv, w_glr            (B, H, W, E·G) packed, index e·G + g, shared by the
                          F node features (K2's weights packed by
                          ``ops.graph.pack_edge_weights``)
  p                       (2, 4): the scalar stencil coefficients of GTV, GLR
  scal                    (5, C): planar rows μ, ρ, γ, α, β

Modes (Q = CᵀC, R = Cᵀ(2·S_γ(C·) − C·), stencil pad "reflect"):

  rhs       out = x + ρ·Q(x)
  cg1       u = −(μ·GLR(x) + ρ·Q(x)) (x is the rhs);  upd = u;  out = x + α·u
  cg2       u = aux − x − (μ·GLR(x) + ρ·Q(x)) + β·prev;  out = x + α·u   (aux = rhs)
  rethresh  out = aux + ρ·R(x)                                           (aux = ỹ)

``pixel_unroll_nhwc`` runs the unroll of ``ops/pixel_unroll.py`` as rhs, cg1,
cg2, rethresh, cg1, cg2, each output rounded to x's dtype as the TPU route
rounds between its calls.

On the card (``kernels/csrc/pixel_nhwc.cu``): a CTA takes one 16×32 output
tile of a group of 4 graphs (bf16; 2 in f32: ``K8_PLANS``) and walks the F
features: the group's E edge weights of the tile come into shared memory
once (one cp.async per pixel and edge) and serve all F; feature f + 1's x
box comes by cp.async into a second buffer while feature f computes and
stays there for the epilogue. The stage planes are f32 [cell][lane] over a
box that is not clipped to the image (``kernels/csrc/padded_tile.cuh``):
halo 2 + r for x (stencil 1, edge sum r, transposed stencil 1; r the
window's radius), 1 + r for the stencil outputs and the weights, 1 for the
edge sums; on diamond-12 1.63× the outputs (3.0× with the 8×16 tiles of
the first port). A cg segment moves x, aux, prev, both weight arrays and
out (on diamond-12 the weights are 4/3 of it) and does ~130 f32 operations
per pixel and channel on diamond-12 (``nhwc_ops_per_pixel``), so it is
bound by bytes. The kernel takes the cross-4, diamond-12 and ring-8 windows,
each with both plans; the plain version takes any window.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.pixel_unroll import edge_ops
from irdu_tpu_torch.ops.windows import (CODE_WINDOWS, DIAMOND12, WINDOW_CODES,
                                        window_code, window_radius)

MODES = ("rhs", "cg1", "cg2", "rethresh")  # the kernel's mode codes, in order
# K8's tile plans (pixel_nhwc.cu), on every window: (rows, columns, graphs a
# CTA, threads); K8_PLAN serves bf16; f32, and a G that is not a multiple of
# the plan's graphs, take plan 0
K8_PLANS = ((16, 32, 2, 256), (16, 32, 4, 256))
K8_PLAN = 1  # 16x32 tiles of 4 graphs: the fastest on diamond-12 in kernels/plan_sweep.py
K8_HALO = 4  # the x box's on diamond-12 (2 + r); the stencil outputs and weights have 1 + r


def nhwc_ops_per_pixel(mode, n_edges=12, stats=True):
    """f32 operations per pixel and channel of a segment, counted as
    ops/pixel_unroll.py counts them (``edge_ops``; ``stats`` False: no
    stencil): rhs Q + 2; cg1 Q + GLR + 3 + 3; cg2 Q + GLR + 3 + 6; rethresh
    R + 2. On diamond-12: 80, 127, 130, 140."""
    q, glr, r = (edge_ops(n_edges, stats, stats)[k] for k in ("q", "glr", "rethresh"))
    return {"rhs": q + 2, "cg1": q + glr + 6, "cg2": q + glr + 9, "rethresh": r + 2}[mode]


def k8_smem_bytes(glr, plan, esize, window=WINDOW_CODES[DIAMOND12]):
    """The shared memory of one K8 CTA on ``window`` (its code;
    ``pixel_nhwc.cu`` Layout): f32 stage planes (S and A of GTV, and of GLR)
    over the tile + 1 + r with a lane per graph of the group, two x boxes
    (tile + 2 + r) and the E weights [e][cell] of each graph operator in the
    input's dtype; each part rounded up to 16 bytes; r the window's
    radius."""
    th, tw, lanes, _ = K8_PLANS[plan]
    deltas = CODE_WINDOWS[window]
    hs = 1 + window_radius(deltas)
    n_p = (th + 2 * hs) * (tw + 2 * hs) * lanes
    n_x = (th + 2 * (hs + 1)) * (tw + 2 * (hs + 1)) * lanes
    na = 2 if glr else 1

    def up16(n):
        return (n + 15) // 16 * 16

    return (up16(4 * 2 * na * n_p) + 2 * up16(esize * n_x)
            + up16(esize * na * len(deltas) * n_p))


def _planes(t, f, g):  # (B, H, W, F·G) planar → (B, F, G, H, W) f32
    b, h, w, _ = t.shape
    return t.float().permute(0, 3, 1, 2).reshape(b, f, g, h, w)


def _nhwc(v, dtype):  # (B, F, G, H, W) → (B, H, W, F·G)
    b, f, g, h, w = v.shape
    return v.reshape(b, f * g, h, w).permute(0, 2, 3, 1).contiguous().to(dtype)


def _edges(wt, n_graphs, n_e):  # packed (B, H, W, E·G) → E × (B, 1, G, H, W) f32
    b, h, w, _ = wt.shape
    wv = wt.float().reshape(b, h, w, n_e, n_graphs).permute(0, 3, 4, 1, 2)
    return [wv[:, e, None] for e in range(n_e)]


def pixel_segment_plain(x, aux, prev, w_gtv, w_glr, p, scal, *, mode, n_graphs,
                        deltas=DIAMOND12):
    """K8 in plain PyTorch (arguments as ``pixel_segment_nhwc``)."""
    g = n_graphs
    f = x.shape[-1] // g
    xv = _planes(x, f, g)
    pad = "reflect"
    p = p.float()
    pg, pl = [p[0, k] for k in range(4)], [p[1, k] for k in range(4)]
    mu, ro, gam, alpha, beta = (scal[k].float().reshape(1, f, g, 1, 1) for k in range(5))
    wg = _edges(w_gtv, g, len(deltas))
    if mode == "rhs":
        return _nhwc(xv + ro * graph.gtv_apply(xv, wg, pg, deltas, pad), x.dtype)
    if mode == "rethresh":
        t = ro * graph.gtv_rethresh_apply(xv, wg, pg, gam, deltas, pad)
        return _nhwc(_planes(aux, f, g) + t, x.dtype)
    wl = _edges(w_glr, g, len(deltas))
    t = (mu * graph.glr_apply(xv, wl, pl, deltas, pad)
         + ro * graph.gtv_apply(xv, wg, pg, deltas, pad))
    if mode == "cg1":
        u = -t
        return _nhwc(xv + alpha * u, x.dtype), _nhwc(u, x.dtype)
    u = _planes(aux, f, g) - xv - t + beta * _planes(prev, f, g)
    return _nhwc(xv + alpha * u, x.dtype)


def _check(x, aux, prev, w_gtv, w_glr, p, scal, mode, n_graphs, deltas):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 4 or x.shape[-1] % n_graphs:
        raise ValueError(f"x must be (B, H, W, F·G) with G = {n_graphs}, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    need = {"aux": mode in ("cg2", "rethresh"), "prev": mode == "cg2",
            "w_glr": mode in ("cg1", "cg2")}
    for name, t in (("aux", aux), ("prev", prev), ("w_glr", w_glr)):
        if need[name] and t is None:
            raise ValueError(f"mode {mode!r} needs {name}")
    wshape = (b, h, w, len(deltas) * n_graphs)
    for name, t, shape in (("aux", aux, x.shape), ("prev", prev, x.shape),
                           ("w_gtv", w_gtv, wshape), ("w_glr", w_glr, wshape),
                           ("p", p, (2, 4)), ("scal", scal, (5, c))):
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def pixel_segment_nhwc(x, aux, prev, w_gtv, w_glr, p, scal, *, mode, n_graphs,
                       deltas=DIAMOND12):
    """One fused segment over the whole image (layouts and modes above):
    returns out, or (out, upd) for cg1, in x's dtype. aux, prev and w_glr are
    None where the mode does not read them.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (the windows of ``WINDOW_CODES``; x, aux, prev and the weights contiguous, on
    one device, of one dtype, f32 or bf16; H, W ≥ 2; p and scal any float
    type) or raises."""
    refuse_grad("pixel_segment_nhwc", x, aux, prev, w_gtv, w_glr, p, scal)
    _check(x, aux, prev, w_gtv, w_glr, p, scal, mode, n_graphs, deltas)
    if library.tracing():
        out = _OP(x, aux, prev, w_gtv, w_glr, p, scal, mode, n_graphs,
                  library.flat_deltas(deltas))
        return tuple(out) if mode == "cg1" else out[0]
    return _run(x, aux, prev, w_gtv, w_glr, p, scal, mode, n_graphs, deltas)


def _run(x, aux, prev, w_gtv, w_glr, p, scal, mode, n_graphs, deltas):
    """The untraced call: the plain version on the CPU, else the launch."""
    used = {"rhs": (x, w_gtv), "cg1": (x, w_gtv, w_glr), "cg2": (x, aux, prev, w_gtv, w_glr),
            "rethresh": (x, aux, w_gtv)}[mode]
    if x.device.type == "cpu":
        return pixel_segment_plain(x, aux, prev, w_gtv, w_glr, p, scal, mode=mode,
                                   n_graphs=n_graphs, deltas=deltas)
    win = window_code(deltas)
    if win is None:
        raise ValueError(f"pixel_segment_nhwc: the kernel takes the cross-4, diamond-12 and "
                         f"ring-8 windows, not {deltas}")
    if x.device.type != "cuda" or any(
            t.device != x.device or t.dtype != x.dtype or not t.is_contiguous() for t in used):
        raise ValueError("pixel_segment_nhwc needs its signal and weight tensors "
                         "contiguous, on one CUDA device, of one dtype")
    b, h, w, c = x.shape
    plan = (K8_PLAN if x.dtype == torch.bfloat16 and n_graphs % K8_PLANS[K8_PLAN][2] == 0
            else 0)
    dev = x.device
    pf = p.to(device=dev, dtype=torch.float32).contiguous()
    sc = scal.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    upd = torch.empty_like(x) if mode == "cg1" else None

    def ptr(t, read):  # a null pointer where the mode does not read the tensor
        return t.data_ptr() if read else None

    lib = kernel_library()
    status = lib.irdu_pixel_segment(
        x.data_ptr(), ptr(aux, mode in ("cg2", "rethresh")), ptr(prev, mode == "cg2"),
        w_gtv.data_ptr(), ptr(w_glr, mode in ("cg1", "cg2")), pf.data_ptr(), sc.data_ptr(),
        out.data_ptr(), ptr(upd, mode == "cg1"), b, h, w,
        n_graphs, c // n_graphs, MODES.index(mode), win, plan, dtype_code(x.dtype),
        torch.cuda.current_stream(dev).cuda_stream)
    check_status("pixel_segment_nhwc", status)
    pixel_segment_nhwc.launches += 1
    return (out, upd) if mode == "cg1" else out


pixel_segment_nhwc.launches = 0
_OP = library.define(
    "pixel_segment_nhwc(Tensor x, Tensor? aux, Tensor? prev, Tensor w_gtv, Tensor? w_glr, "
    "Tensor p, Tensor scal, str mode, int n_graphs, int[] deltas) -> Tensor[]",
    lambda *a: (lambda out: list(out) if a[7] == "cg1" else [out])(
        _run(*a[:9], library.window(a[9]))),
    lambda x, *a: [x.new_empty(x.shape) for _ in range(2 if a[6] == "cg1" else 1)])


def pixel_unroll_nhwc(y72, w_gtv, w_glr, p, scal, *, n_graphs, deltas=DIAMOND12):
    """The fixed 2-round unroll as 6 segments (counterpart:
    ``irdu_tpu/ops/pallas/pixel_nhwc.py:pixel_unroll_nhwc``). y72: (B, H, W, C)
    planar ỹ repeated over the graphs; w_gtv, w_glr packed weights; p (2, 4);
    scal: planar (C,) vectors ``mu``, ``ro``, ``gamma`` and (4, C) ``alpha``,
    ``beta``. Returns (B, H, W, C) in y72's dtype."""
    zeros = torch.zeros_like(scal["mu"], dtype=torch.float32)

    def rows(alpha=None, beta=None):
        return torch.stack([scal["mu"].float(), scal["ro"].float(), scal["gamma"].float(),
                            zeros if alpha is None else alpha.float(),
                            zeros if beta is None else beta.float()])

    def seg(x, aux, prev, w_l, sc, mode):
        return pixel_segment_nhwc(x, aux, prev, w_gtv, w_l, p, sc, mode=mode,
                                  n_graphs=n_graphs, deltas=deltas)

    a, bt = scal["alpha"], scal["beta"]
    # round 1: rhs = ỹ + ρ·CᵀC ỹ (ε = Cỹ, bias 0)
    rhs = seg(y72, None, None, None, rows(), "rhs")
    out, upd = seg(rhs, None, None, w_glr, rows(alpha=a[0]), "cg1")
    out = seg(out, rhs, upd, w_glr, rows(alpha=a[1], beta=bt[1]), "cg2")
    # the ADMM re-threshold: rhs' = ỹ + ρ·Cᵀ(2·S_γ(Cx) − Cx)
    rhs = seg(out, y72, None, None, rows(), "rethresh")
    # round 2: CG restarts from the new rhs
    out, upd = seg(rhs, None, None, w_glr, rows(alpha=a[2]), "cg1")
    return seg(out, rhs, upd, w_glr, rows(alpha=a[3], beta=bt[3]), "cg2")
