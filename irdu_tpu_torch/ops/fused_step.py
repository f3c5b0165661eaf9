"""K5, K6a, K6b: one unroll step of the GGTV+GGLR solvers, and its
single-scale pieces, CHW. The flagship's band route (``solvers/gtv_glr.py``:
planes too large for K1, and every plane of a window other than cross-4) is
five two-scale K5 calls per filtering block; the pixel family's CHW route
above K7's cap (``solvers/pixel_gtv.py``) is six single-scale K5 calls on
its window with the reflect stencil pad.

Replaces the TPU kernels of ``irdu_tpu/ops/pallas/solver_chw.py``:

  K5  ``gg_fused_step_chw`` (body ``_fused_kernel``): one step, two-scale
      or single-scale (no Up(…) term), in one of three modes over
      x (B, C, H, W), C = G·F:
        rhs:       out = x + ρ₀·Q₀x + Up(ρ₁·Q₁·Dn x)
        cg:        upd = rhs − A·x [+ β·prev];  out = x + α·upd
                   A·x = x + μ₀GLR₀x + ρ₀Q₀x + Up((μ₁GLR₁ + ρ₁Q₁)·Dn x)
                   (``use_x_rhs``: x is the rhs; ``emit_update``: upd too)
        rethresh:  out = [y +] ρ₀·R₀x + Up(ρ₁·R₁·Dn x)
  K6a ``gg_matvec_chw`` (``_matvec_kernel``): [x +] μ·GLR(x) + ρ·Q(x), one scale.
  K6b ``gtv_rethresh_chw`` (``_rethresh_kernel``): [y +] ρ·R(x), one scale.

Q = CᵀC is the GTV quadratic term, R = Cᵀ(2·S_γ(C·) − C·) the ADMM
re-threshold, GLR = statsᵀ(I − W·shift)stats; Dn is the 2×2 box mean and Up
its adjoint (duplicate and scale by 0.25). Per-graph scalars come in K5's
(G, 8) table [μ₀, ρ₀, μ₁, ρ₁, α, β, γ₀, γ₁] (``fused_scal``); K6a and K6b
build theirs from (G,) vectors. Compute is f32; each call's outputs are
rounded to x's dtype, as the TPU route rounds between its calls.

On the card, K5, K6a and K6b are one kernel,
``kernels/csrc/fused_step_hopper.cu`` (K6a and K6b are its single-scale
launches with their own epilogues: x + T or T for the matvec, [y +] T for
the re-threshold): a CTA takes one output tile (32×64 full-res pixels
two-scale on cross-4, 16×64 on ring-8 and 16×32 on diamond-12, whose
weights of both scales would outgrow a CTA in f32 at 32×64; 16×64
single-scale: ``k5_tile``) of one graph and walks its F channel planes.
The tile's edge weights of both scales come into shared
memory once, in x's dtype, and serve all F planes; plane f + 1's x box
comes by cp.async into a second buffer while plane f computes. The stage
planes (the stencil outputs, the edge sums) are f32 in shared memory over a
box that is not clipped to the image: a cell outside it holds what the
reference's padding gives there (``kernels/csrc/padded_tile.cuh``), so
reads need no clamp. Halos: the window's radius r (``window_radius``: 1
on cross-4 and ring-8, 2 on diamond-12), the edge sums on the tile + 1, the
stencils and weights on the tile + 1 + r, x on the tile + 2 + r (two-scale:
twice the half tile's, 2·(2 + r), for the box means). Per full-res
pixel a cg step moves 5 planes of x's dtype plus the per-graph weights and
does ~93 f32 operations, so it is bound by bytes; so are K6a and K6b.

Boundaries: a shift of a derived array (the stencil output, ε) replicates
that array's own edge, which the padded tile's S cells outside the image
hold (the stencil at the pixel clamped to the image); the Cᵀ scatter and
statsᵀ read zeros outside the image, which the weight and edge-sum cells
there hold. JAX's band kernel carries 2r + 2 rows of x (6 on diamond-12)
because it shifts whole edge-signal arrays; the per-pixel edge sum reads
the stencil plane at p ± d only, so the halos above serve every window.

Windows and pads: the kernel takes the cross-4, diamond-12 and ring-8
windows (``KERNEL_WINDOWS``), each on one or two scales, with the "edge"
stencil pad (the flagship) or the "reflect" pad (the pixel family: numpy
reflect, edge excluded, for the stencil's own input; the derived arrays keep
replicating their own edge, the scatter stays zero-padded). K5's pixel mode
is single-scale (the ``w_*1`` weights None). A stats table set to None (the
no-stats variants) goes to the kernel as the identity stencil (1, 0, 0, 0),
which computes the same values exactly. The plain versions take any window
and either pad.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops import graph
from irdu_tpu_torch.ops.graph import box_down2x2, box_up2x2
from irdu_tpu_torch.ops.windows import (CODE_WINDOWS, CROSS4, DIAMOND12, RING8, WINDOW_CODES,
                                        window_code, window_radius)

MODES = ("rhs", "cg", "rethresh")
# the windows the kernel is built for, by the code it takes (fused_step_hopper.cu)
KERNEL_WINDOWS = WINDOW_CODES
# K5's tile (fused_step_hopper.cu tile_at): (rows, columns, threads) of a
# step on one scale (every window) and on two (cross-4; the other windows
# take smaller tiles, whose f32 weights of both scales fit a CTA:
# k5_smem_bytes)
K5_TILES = {False: (16, 64, 256), True: (32, 64, 256)}
K5_TWO_SCALE_TILES = {WINDOW_CODES[RING8]: (16, 64, 256), WINDOW_CODES[DIAMOND12]: (16, 32, 256)}
STATS_PADS = ("edge", "reflect")
# the kernel's epilogues (fused_step_hopper.cu)
_EPI_ADD_X, _EPI_ADD_AUX, _EPI_CG = 0, 1, 2


def fused_scal(n_graphs, mu0=None, ro0=None, mu1=None, ro1=None,
               alpha=None, beta=None, gamma0=None, gamma1=None):
    """The (G, 8) f32 table [μ₀, ρ₀, μ₁, ρ₁, α, β, γ₀, γ₁] of K5; entries
    left None are zero."""
    vals = (mu0, ro0, mu1, ro1, alpha, beta, gamma0, gamma1)
    given = [torch.as_tensor(v) for v in vals if v is not None]
    dev = given[0].device if given else None
    cols = [torch.zeros(n_graphs, device=dev) if v is None
            else torch.as_tensor(v, device=dev).float().reshape(n_graphs) for v in vals]
    return torch.stack(cols, dim=1).contiguous()


def identity_table(n_graphs, n_node_fts, device=None):
    """The (G, 4, F) stats table of the identity stencil, rows (1, 0, 0, 0):
    the kernels' stand-in for a table set to None (p01·x + 0 is x exactly)."""
    tab = torch.zeros(n_graphs, 4, n_node_fts, device=device)
    tab[:, 0] = 1.0
    return tab


def k5_tile(two_scale, window):
    """The tile of a step on ``window`` (the ``KERNEL_WINDOWS`` code)."""
    return K5_TWO_SCALE_TILES.get(window, K5_TILES[True]) if two_scale else K5_TILES[False]


def k5_geometry(window, two_scale):
    """K5's boxes for its tile (``fused_step_hopper.cu`` Geo): the tile
    (th, tw); the stage planes' halo, hs = 1 + r rows and hsc (hs rounded up
    to even) columns; the x box's, hxr rows, 2 + r or, two-scale, 2·(2 + r)
    for the half tile's box means, and 8 columns (its rows start on 16-byte
    chunks); r the window's radius. Half-res planes have the full-res
    halos."""
    th, tw, _ = k5_tile(two_scale, window)
    r = window_radius(CODE_WINDOWS[window])
    hs = 1 + r
    return dict(th=th, tw=tw, r=r, hs=hs, hsc=(hs + 1) & ~1,
                hxr=2 * (2 + r) if two_scale else 2 + r, hxc=8)


def k5_smem_bytes(window, two_scale, glr, esize):
    """The shared memory of one K5 CTA (``fused_step_hopper.cu`` Layout): f32
    stage planes (S and A of GTV, and of GLR) over the tile and its
    ``k5_geometry`` halo, the same at half res, two x boxes and the weights
    [e][cell] of each scale in the input's dtype; each part rounded up to
    16 bytes."""
    geo = k5_geometry(window, two_scale)
    th, tw, hs, hsc = geo["th"], geo["tw"], geo["hs"], geo["hsc"]
    n_e = len(CODE_WINDOWS[window])
    n_p = (th + 2 * hs) * (tw + 2 * hsc)
    n_p1 = (th // 2 + 2 * hs) * (tw // 2 + 2 * hsc) if two_scale else 0
    n_x = (th + 2 * geo["hxr"]) * (tw + 2 * geo["hxc"])
    na = 2 if glr else 1

    def up16(n):
        return (n + 15) // 16 * 16

    return (up16(4 * 2 * na * n_p) + up16(4 * 2 * na * n_p1) + 2 * up16(esize * n_x)
            + up16(esize * na * n_e * n_p) + up16(esize * na * n_e * n_p1))


def _weights(wt):  # (B, G, E, h, w) → E × (B, G, 1, h, w) f32
    wt = wt.float()
    return [wt[:, :, e:e + 1] for e in range(wt.shape[2])]


def _per_graph(v, g, device):  # (G,) → (G, 1, 1, 1) f32
    return torch.as_tensor(v, device=device).float().reshape(g, 1, 1, 1)


def _scale_term(x, w_gtv, w_glr, pgtv, pglr, ro, mu, gamma, rethresh, with_glr,
                deltas, pad):
    """ρ·R(x), or ρ·Q(x) [+ μ·GLR(x)], on one scale."""
    wg, pg = _weights(w_gtv), graph.stats_table_terms(pgtv)
    if rethresh:
        return ro * graph.gtv_rethresh_apply(x, wg, pg, gamma, deltas, pad)
    t = ro * graph.gtv_apply(x, wg, pg, deltas, pad)
    if with_glr:
        t = t + mu * graph.glr_apply(x, _weights(w_glr), graph.stats_table_terms(pglr),
                                     deltas, pad)
    return t


def fused_step_plain(x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0,
                     pgtv1, pglr1, scal, *, mode, n_graphs, deltas=CROSS4,
                     stats_mode="edge", with_glr=True, use_x_rhs=False,
                     emit_update=False):
    """K5 in plain PyTorch (arguments as ``gg_fused_step_chw``)."""
    _check_pad(stats_mode)
    b, c, h, w = x.shape
    g = n_graphs
    shape5 = (b, g, c // g, h, w)
    xv = x.float().reshape(shape5)
    d = tuple(deltas)

    mu0, ro0, mu1, ro1, alpha, beta, gam0, gam1 = (
        _per_graph(scal[:, k], g, x.device) for k in range(8))
    rethresh, glr = mode == "rethresh", mode == "cg" and with_glr
    t = _scale_term(xv, w_gtv0, w_glr0, pgtv0, pglr0, ro0, mu0, gam0, rethresh, glr,
                    d, stats_mode)
    if w_gtv1 is not None:
        t = t + box_up2x2(_scale_term(box_down2x2(xv), w_gtv1, w_glr1, pgtv1, pglr1,
                                      ro1, mu1, gam1, rethresh, glr, d, stats_mode))

    def out_of(v):
        return v.reshape(b, c, h, w).to(x.dtype)

    if mode == "rhs":
        return out_of(xv + t)
    if mode == "rethresh":
        return out_of(t if aux is None else t + aux.float().reshape(shape5))
    rhs = xv if use_x_rhs else aux.float().reshape(shape5)
    upd = rhs - (xv + t)
    if prev is not None:
        upd = upd + beta * prev.float().reshape(shape5)
    out = out_of(xv + alpha * upd)
    return (out, out_of(upd)) if emit_update else out


def matvec_plain(x, w_glr, w_gtv, pglr, pgtv, mu, ro, *, n_graphs, deltas=CROSS4,
                 stats_mode="edge", add_identity=True, with_glr=True):
    """K6a in plain PyTorch (arguments as ``gg_matvec_chw``)."""
    _check_pad(stats_mode)
    b, c, h, w = x.shape
    g = n_graphs
    xv = x.float().reshape(b, g, c // g, h, w)
    t = _scale_term(xv, w_gtv, w_glr, pgtv, pglr, _per_graph(ro, g, x.device),
                    _per_graph(mu, g, x.device), None, False, with_glr, tuple(deltas),
                    stats_mode)
    return (xv + t if add_identity else t).reshape(b, c, h, w).to(x.dtype)


def rethresh_plain(x, y, w_gtv, pgtv, gamma, ro, *, n_graphs, deltas=CROSS4,
                   stats_mode="edge"):
    """K6b in plain PyTorch (arguments as ``gtv_rethresh_chw``)."""
    _check_pad(stats_mode)
    b, c, h, w = x.shape
    g = n_graphs
    xv = x.float().reshape(b, g, c // g, h, w)
    t = _scale_term(xv, w_gtv, None, pgtv, None, _per_graph(ro, g, x.device), None,
                    _per_graph(gamma, g, x.device), True, False, tuple(deltas), stats_mode)
    if y is not None:
        t = t + y.float().reshape(xv.shape)
    return t.reshape(b, c, h, w).to(x.dtype)


def _check_pad(stats_mode):
    if stats_mode not in STATS_PADS:
        raise ValueError(f"stats_mode must be one of {STATS_PADS}, got {stats_mode!r}")


def _check_planes(name, x, operands, n_graphs, two_scale, deltas, stats_mode):
    """The pad, and the shapes of x and of the (kind, argument name, tensor)
    operands, a None tensor skipped: kind "plane" is x's shape, "w0" and "w1"
    full- and half-res edge weights of the window, "table" a stats table,
    "scal" K5's scalars."""
    _check_pad(stats_mode)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % n_graphs:
        raise ValueError(f"{name}: C={c} must split into {n_graphs} graphs")
    if two_scale and (h % 2 or w % 2):
        raise ValueError(f"{name}: H and W must be even for the two-scale step, got {h}x{w}")
    g, e = n_graphs, len(deltas)
    shapes = {"plane": (b, c, h, w), "w0": (b, g, e, h, w), "w1": (b, g, e, h // 2, w // 2),
              "table": (g, 4, c // g), "scal": (g, 8)}
    for kind, arg, t in operands:
        if t is not None and tuple(t.shape) != shapes[kind]:
            raise ValueError(f"{name}: {arg} must be {shapes[kind]}, got {tuple(t.shape)}")


def _launch(name, x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, tables, scal, *,
            n_graphs, deltas, stats_mode, rethresh, glr, epi, use_x_rhs=False,
            emit_update=False):
    """Run the kernel (``fused_step_hopper.cu``) on the card; returns out or
    (out, upd).
    ``tables``: GTV, GLR at full res, then at half res; a None table the
    kernel reads goes to it as the identity stencil."""
    two_scale = w_gtv1 is not None
    win = window_code(deltas)
    if win is None:
        raise ValueError(f"{name}: the kernel takes the cross-4, diamond-12 and ring-8 "
                         f"windows, not {deltas}")
    planes = [t for t in (x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1) if t is not None]
    if any(t.device != x.device or t.dtype != x.dtype or not t.is_contiguous()
           for t in planes) or x.device.type != "cuda":
        raise ValueError(f"{name} needs x, its other planes and the weights contiguous, "
                         "on one CUDA device, of one dtype")
    b, c, h, w = x.shape
    if b * n_graphs > 65535:
        raise ValueError(f"{name}: B·G exceeds the grid's 65535")
    if stats_mode == "reflect" and min(h, w) < 2:
        raise ValueError(f"{name}: the reflect pad needs H, W ≥ 2, got {h}x{w}")
    dev = x.device
    used = [k for k in range(4) if (k % 2 == 0 or glr) and (k < 2 or two_scale)]
    tabs = [None if k not in used
            else identity_table(n_graphs, c // n_graphs, dev) if tables[k] is None
            else tables[k].to(device=dev, dtype=torch.float32).contiguous()
            for k in range(4)]
    sc = scal.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    upd = torch.empty_like(x) if emit_update else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = kernel_library().irdu_fused_step_hopper(
        ptr(x), ptr(aux), ptr(prev), ptr(w_gtv0), ptr(w_glr0), ptr(w_gtv1), ptr(w_glr1),
        *(ptr(t) for t in tabs), ptr(sc), ptr(out), ptr(upd), b, n_graphs, c // n_graphs, h, w,
        int(rethresh), int(glr), epi, int(use_x_rhs), win, int(stats_mode == "reflect"),
        dtype_code(x.dtype), torch.cuda.current_stream(dev).cuda_stream)
    check_status(name, status)
    return (out, upd) if emit_update else out


def gg_fused_step_chw(x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0,
                      pgtv1, pglr1, scal, *, mode, n_graphs, deltas=CROSS4,
                      stats_mode="edge", with_glr=True, use_x_rhs=False,
                      emit_update=False):
    """One fused unroll step (the mode table above). x (B, C, H, W), C = G·F;
    aux: the rhs ("cg", unless ``use_x_rhs``) or y ("rethresh", optional),
    else unused; prev: the previous CG update (β momentum, "cg") or None;
    w_*0 (B, G, E, H, W) and w_*1 (B, G, E, H/2, W/2) edge weights over the
    window ``deltas`` (E offsets), w_*1 None for a single-scale step; p*
    (G, 4, F) stats tables or None; scal (G, 8) from ``fused_scal``;
    stats_mode the stencil's pad, "edge" or "reflect". Returns out, or
    (out, upd) with ``emit_update`` ("cg" only), in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (x, aux, prev and the weights contiguous, of one dtype: f32 or bf16;
    the windows of ``KERNEL_WINDOWS``) or raises."""
    refuse_grad("gg_fused_step_chw", x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0,
                pgtv1, pglr1, scal)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if emit_update and mode != "cg":
        raise ValueError("emit_update is for mode 'cg' only")
    if mode == "cg" and not use_x_rhs and aux is None:
        raise ValueError("mode 'cg' needs aux (the rhs) unless use_x_rhs")
    glr = mode == "cg" and with_glr
    two_scale = w_gtv1 is not None
    _check_planes("gg_fused_step_chw", x, [
        ("plane", "aux", aux if mode != "rhs" else None),
        ("plane", "prev", prev if mode == "cg" else None),
        ("w0", "w_gtv0", w_gtv0), ("w0", "w_glr0", w_glr0 if glr else None),
        ("w1", "w_gtv1", w_gtv1), ("w1", "w_glr1", w_glr1 if glr and two_scale else None),
        ("table", "pgtv0", pgtv0), ("table", "pglr0", pglr0),
        ("table", "pgtv1", pgtv1), ("table", "pglr1", pglr1), ("scal", "scal", scal)],
        n_graphs, two_scale, deltas, stats_mode)
    args = (x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0, pgtv1, pglr1, scal,
            mode, n_graphs)
    if library.tracing():
        out = _STEP_OP(*args, library.flat_deltas(deltas), stats_mode, with_glr, use_x_rhs,
                       emit_update)
        return tuple(out) if emit_update else out[0]
    return _run_step(*args, deltas, stats_mode, with_glr, use_x_rhs, emit_update)


def _run_step(x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0, pglr0, pgtv1, pglr1, scal,
              mode, n_graphs, deltas, stats_mode, with_glr, use_x_rhs, emit_update):
    """The untraced call: the plain version on the CPU, else the launch."""
    glr = mode == "cg" and with_glr
    two_scale = w_gtv1 is not None
    kw = dict(mode=mode, n_graphs=n_graphs, deltas=deltas, stats_mode=stats_mode,
              with_glr=with_glr, use_x_rhs=use_x_rhs, emit_update=emit_update)
    if x.device.type == "cpu":
        return fused_step_plain(x, aux, prev, w_gtv0, w_glr0, w_gtv1, w_glr1, pgtv0,
                                pglr0, pgtv1, pglr1, scal, **kw)
    epi = {"rhs": _EPI_ADD_X, "rethresh": _EPI_ADD_AUX, "cg": _EPI_CG}[mode]
    out = _launch("gg_fused_step_chw", x, aux if mode != "rhs" else None,
                  prev if mode == "cg" else None, w_gtv0, w_glr0 if glr else None,
                  w_gtv1, w_glr1 if glr and two_scale else None,
                  (pgtv0, pglr0, pgtv1, pglr1), scal, n_graphs=n_graphs, deltas=deltas,
                  stats_mode=stats_mode, rethresh=mode == "rethresh", glr=glr, epi=epi,
                  use_x_rhs=use_x_rhs, emit_update=emit_update)
    gg_fused_step_chw.launches += 1
    return out


gg_fused_step_chw.launches = 0


def gg_matvec_chw(x, w_glr, w_gtv, pglr, pgtv, mu, ro, *, n_graphs, deltas=CROSS4,
                  stats_mode="edge", add_identity=True, with_glr=True):
    """[x +] μ⊙GLR(x) + ρ⊙Q(x) on one scale. x (B, C, H, W); w_glr, w_gtv
    (B, G, E, H, W), w_glr unused without ``with_glr``; pglr, pgtv (G, 4, F)
    or None; mu, ro (G,). Returns x's shape and dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    refuse_grad("gg_matvec_chw", x, w_glr, w_gtv, pglr, pgtv, mu, ro)
    _check_planes("gg_matvec_chw", x, [
        ("w0", "w_glr", w_glr if with_glr else None), ("w0", "w_gtv", w_gtv),
        ("table", "pglr", pglr), ("table", "pgtv", pgtv)], n_graphs, False, deltas,
        stats_mode)
    if library.tracing():
        return _MATVEC_OP(x, w_glr, w_gtv, pglr, pgtv, _f32(mu, x), _f32(ro, x), n_graphs,
                          library.flat_deltas(deltas), stats_mode, add_identity, with_glr)
    return _run_matvec(x, w_glr, w_gtv, pglr, pgtv, mu, ro, n_graphs, deltas, stats_mode,
                       add_identity, with_glr)


def _f32(v, x):
    """A per-graph scalar as the f32 tensor an operator takes."""
    return torch.as_tensor(v, dtype=torch.float32, device=x.device)


def _run_matvec(x, w_glr, w_gtv, pglr, pgtv, mu, ro, n_graphs, deltas, stats_mode,
                add_identity, with_glr):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        return matvec_plain(x, w_glr, w_gtv, pglr, pgtv, mu, ro, n_graphs=n_graphs,
                            deltas=deltas, stats_mode=stats_mode,
                            add_identity=add_identity, with_glr=with_glr)
    scal = fused_scal(n_graphs, mu0=mu if with_glr else None, ro0=ro)
    out = _launch("gg_matvec_chw", x, None, None, w_gtv, w_glr if with_glr else None,
                  None, None, (pgtv, pglr, None, None), scal, n_graphs=n_graphs,
                  deltas=deltas, stats_mode=stats_mode, rethresh=False, glr=with_glr,
                  epi=_EPI_ADD_X if add_identity else _EPI_ADD_AUX)
    gg_matvec_chw.launches += 1
    return out


gg_matvec_chw.launches = 0


def gtv_rethresh_chw(x, y, w_gtv, pgtv, gamma, ro, *, n_graphs, deltas=CROSS4,
                     stats_mode="edge"):
    """[y +] ρ⊙Cᵀ(2·S_γ(Cx) − Cx) on one scale. x, y (B, C, H, W), y may be
    None; w_gtv (B, G, E, H, W); pgtv (G, 4, F) or None; gamma, ro (G,).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    refuse_grad("gtv_rethresh_chw", x, y, w_gtv, pgtv, gamma, ro)
    _check_planes("gtv_rethresh_chw", x, [
        ("plane", "y", y), ("w0", "w_gtv", w_gtv), ("table", "pgtv", pgtv)], n_graphs,
        False, deltas, stats_mode)
    if library.tracing():
        return _RETHRESH_OP(x, y, w_gtv, pgtv, _f32(gamma, x), _f32(ro, x), n_graphs,
                            library.flat_deltas(deltas), stats_mode)
    return _run_rethresh(x, y, w_gtv, pgtv, gamma, ro, n_graphs, deltas, stats_mode)


def _run_rethresh(x, y, w_gtv, pgtv, gamma, ro, n_graphs, deltas, stats_mode):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        return rethresh_plain(x, y, w_gtv, pgtv, gamma, ro, n_graphs=n_graphs,
                              deltas=deltas, stats_mode=stats_mode)
    scal = fused_scal(n_graphs, ro0=ro, gamma0=gamma)
    out = _launch("gtv_rethresh_chw", x, y, None, w_gtv, None, None, None,
                  (pgtv, None, None, None), scal, n_graphs=n_graphs, deltas=deltas,
                  stats_mode=stats_mode, rethresh=True, glr=False, epi=_EPI_ADD_AUX)
    gtv_rethresh_chw.launches += 1
    return out


gtv_rethresh_chw.launches = 0


def _like(x, *rest):
    return x.new_empty(x.shape)


_STEP_OP = library.define(
    "gg_fused_step_chw(Tensor x, Tensor? aux, Tensor? prev, Tensor w_gtv0, Tensor? w_glr0, "
    "Tensor? w_gtv1, Tensor? w_glr1, Tensor? pgtv0, Tensor? pglr0, Tensor? pgtv1, "
    "Tensor? pglr1, Tensor scal, str mode, int n_graphs, int[] deltas, str stats_mode, "
    "bool with_glr, bool use_x_rhs, bool emit_update) -> Tensor[]",
    lambda *a: list(_as_tuple(_run_step(*a[:14], library.window(a[14]), *a[15:]))),
    lambda x, *a: [x.new_empty(x.shape) for _ in range(2 if a[-1] else 1)])
_MATVEC_OP = library.define(
    "gg_matvec_chw(Tensor x, Tensor? w_glr, Tensor w_gtv, Tensor? pglr, Tensor? pgtv, "
    "Tensor mu, Tensor ro, int n_graphs, int[] deltas, str stats_mode, bool add_identity, "
    "bool with_glr) -> Tensor",
    lambda *a: _run_matvec(*a[:8], library.window(a[8]), *a[9:]), _like)
_RETHRESH_OP = library.define(
    "gtv_rethresh_chw(Tensor x, Tensor? y, Tensor w_gtv, Tensor? pgtv, Tensor gamma, "
    "Tensor ro, int n_graphs, int[] deltas, str stats_mode) -> Tensor",
    lambda *a: _run_rethresh(*a[:7], library.window(a[7]), a[8]), _like)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)
