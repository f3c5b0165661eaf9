"""K9: the single-scale system matvec of the GTV+GLR solver, channels-last.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/solver_matvec.py:fused_system_matvec``
(body ``_kernel``), parked in JAX and here the matvec of the single-scale
ablation solver (``solvers/ablation_solvers.py`` ``GTVGLRSingleScale``, three
calls per forward):

  out = x + μ⊙GLR(x) + ρ⊙GTV(x)
  GLR(x) = statsᵀ(s − Σ_e w_e·shift_e s),  s = stats(x)
  GTV(x) = CᵀC x = statsᵀ(Σ_e [w_e²·(s₂ − shift_e s₂) − shift₋ₑ⁰(…)]),  s₂ = stats(x)

on the cross-4 window, with JAX's signature and layout: x (B, H, W, C),
C = G·F, channel c in graph c // F; edge weights (B, H, W, G, 4); stencil
rows (4, C) = p01, p02a, p02b, p03 per channel (K5's tables are (G, 4, F):
a different layout); μ, ρ (C,) per channel (exp already applied). Rows set
to None (the no-stats ablations) are the identity stencil: the kernel takes
rows (1, 0, 0, 0), which compute the same values exactly. JAX's boundary
rules (``solver_matvec.py:19-23``): x replicates its edge; a shift of a
derived array replicates that array's own edge; the Cᵀ scatter and statsᵀ
read zeros; the stencil pads by replication ("edge"). Compute is f32; the
output is in x's dtype. JAX casts the weights, rows and scales to x's dtype;
the port casts the weights to it and keeps the rows and scales in f32, as its
other kernels do.

On the card (``kernels/csrc/system_matvec.cu``): K5's padded tile
(``kernels/csrc/padded_tile.cuh``) on the cross-4 window with channel lanes.
A CTA takes one 16×16 output tile (``K9_TILE``) of one image and walks
the C channels graph by graph in chunks of 8 lanes (a chunk never straddles
two graphs; the last of a graph may be partial); the graph's 4 GLR and 4
GTV weights of the tile come into shared memory once and serve all its
chunks (at G = 1 all of them); the next chunk's x box (8 lanes a cell, one
16-byte cp.async in bf16) comes into a second buffer while the chunk
computes; the f32 stage planes are [cell][lane] over boxes not clipped to
the image: x on the tile + 3 (1.9× the tile's pixels at 16×16), S and the
weights on the tile + 2, the edge sums on the tile + 1; the output leaves
in 16-byte stores. JAX's TPU rules (H % 8, W % 8) are not copied: the kernel
takes any H, W and G. Per pixel and channel it reads and writes one element
(2 bytes each in bf16) and does 69 f32 operations
(``OPS_PER_PIXEL_CHANNEL``), so at F = 96 it is bound by bytes.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad
from irdu_tpu_torch.ops import graph

# f32 operations per pixel and channel, each edge term once (an add, mul or
# compare 1, an FMA 2): the two stencils 9 each; the GTV edge sum 3·4 and the
# scatter 2·4; GLR's Laplacian 2·4 + 1; the two transposed stencils 9 each;
# ρ·, μ· and the two adds 4: 69, as K6a with GLR and the identity.
OPS_PER_PIXEL_CHANNEL = 69
# K9's tile, as system_matvec.cu has it: (rows, columns, lanes, threads,
# CTAs an SM); 16x16 tiles of 8 lanes, the fastest of 8x32, 16x32 and 16x16
# on the card (PERF.md, K9's design note)
K9_TILE = (16, 16, 8, 256, 2)
K9_HALO = 3  # the x box's; S and the weights have 2, the edge sums 1


def k9_smem_bytes(dtype):
    """The shared memory of one K9 CTA in ``dtype`` (``system_matvec.cu``
    Layout): four f32 stage planes (S and A of GTV and GLR) of 8 lanes a
    cell over the tile + 2, two x boxes of 8 lanes over the tile + 3 in the
    input's dtype, the 4 weights [cell][edge] of both operators over the
    tile + 2, and two tables of 10 f32 coefficients a lane; each part rounded
    up to 16 bytes."""
    th, tw, lanes, _, _ = K9_TILE
    esize = torch.tensor([], dtype=dtype).element_size()
    n_p = (th + 2 * (K9_HALO - 1)) * (tw + 2 * (K9_HALO - 1))
    n_x = (th + 2 * K9_HALO) * (tw + 2 * K9_HALO)

    def up16(n):
        return (n + 15) // 16 * 16

    return (up16(4 * 4 * n_p * lanes) + 2 * up16(esize * n_x * lanes)
            + up16(esize * 2 * 4 * n_p) + 2 * up16(4 * 10 * lanes))


def identity_rows(c, device=None):
    """The (4, C) stencil rows of the identity: (1, 0, 0, 0) per channel."""
    rows = torch.zeros(4, c, device=device)
    rows[0] = 1.0
    return rows


def _chw_terms(rows, g, f):
    """(4, C) rows → the four coefficients, each (G, F, 1, 1) f32; None stays None."""
    if rows is None:
        return None
    rows = rows.float()
    return [rows[k].reshape(g, f, 1, 1) for k in range(4)]


def system_matvec_plain(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, *, n_graphs):
    """K9 in plain PyTorch (arguments as ``fused_system_matvec``): x permuted
    to (B, G, F, H, W), the operators of ``ops/graph.py``, f32, the output
    permuted back and rounded to x's dtype."""
    b, h, w, c = x.shape
    g = n_graphs
    f = c // g
    xv = x.float().permute(0, 3, 1, 2).reshape(b, g, f, h, w)

    def edges(wt):  # (B, H, W, G, 4) → 4 × (B, G, 1, H, W)
        wt = wt.float().permute(0, 3, 4, 1, 2)
        return [wt[:, :, e:e + 1] for e in range(4)]

    mu, ro = mu_c.float().reshape(g, f, 1, 1), ro_c.float().reshape(g, f, 1, 1)
    out = (xv + mu * graph.glr_apply(xv, edges(w_glr), _chw_terms(stats_glr, g, f))
           + ro * graph.gtv_apply(xv, edges(w_gtv), _chw_terms(stats_gtv, g, f)))
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(x.dtype)


def _check(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, n_graphs):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % n_graphs:
        raise ValueError(f"C={c} must split into {n_graphs} graphs")
    for name, t, shape in (("w_glr", w_glr, (b, h, w, n_graphs, 4)),
                           ("w_gtv", w_gtv, (b, h, w, n_graphs, 4)),
                           ("stats_glr", stats_glr, (4, c)), ("stats_gtv", stats_gtv, (4, c)),
                           ("mu_c", mu_c, (c,)), ("ro_c", ro_c, (c,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def fused_system_matvec(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, *, n_graphs):
    """x + μ⊙GLR(x) + ρ⊙GTV(x) on one scale, cross-4. x (B, H, W, C);
    w_glr, w_gtv (B, H, W, G, 4) softmax edge weights; stats_glr, stats_gtv
    (4, C) stencil rows or None (identity); mu_c, ro_c (C,). Returns x's shape
    and dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (x contiguous, f32 or bf16; the weights cast to x's dtype, the rows and
    scales to f32) or raises."""
    refuse_grad("fused_system_matvec", x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c)
    _check(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, n_graphs)
    run = _OP if library.tracing() else _run
    return run(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, n_graphs)


def _run(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c, n_graphs):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        return system_matvec_plain(x, w_glr, w_gtv, stats_glr, stats_gtv, mu_c, ro_c,
                                   n_graphs=n_graphs)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("fused_system_matvec needs a contiguous CUDA or CPU tensor")
    b, h, w, c = x.shape
    dev = x.device

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    wl, wg = (t.to(device=dev, dtype=x.dtype).contiguous() for t in (w_glr, w_gtv))
    pl, pg = (identity_rows(c, dev) if t is None else f32(t) for t in (stats_glr, stats_gtv))
    mu, ro = f32(mu_c), f32(ro_c)
    out = torch.empty_like(x)
    status = kernel_library().irdu_system_matvec(
        x.data_ptr(), wl.data_ptr(), wg.data_ptr(), pl.data_ptr(), pg.data_ptr(),
        mu.data_ptr(), ro.data_ptr(), out.data_ptr(), b, h, w, c, n_graphs, dtype_code(x.dtype),
        torch.cuda.current_stream(dev).cuda_stream)
    check_status("fused_system_matvec", status)
    fused_system_matvec.launches += 1
    return out


fused_system_matvec.launches = 0
_OP = library.define(
    "fused_system_matvec(Tensor x, Tensor w_glr, Tensor w_gtv, Tensor? stats_glr, "
    "Tensor? stats_gtv, Tensor mu_c, Tensor ro_c, int n_graphs) -> Tensor", _run,
    lambda x, *rest: x.new_empty(x.shape))
