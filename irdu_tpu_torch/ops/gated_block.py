"""K4: one LocalNonLinearBlock of the flagship, CHW, and the block kernel's
launcher that K3 (``ops/block_stack.py``) shares.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/gated_block.py:fused_gated_block``
(body ``_kernel``). One block: CustomLayerNorm (x / sqrt(var + 1e-5) · scale,
the variance unbiased over channels, the mean not subtracted), 1×1 expand
C → 2H, 3×3 depthwise with replicate padding, gate σ(m)·m·u over the two
halves, 1×1 project H → C, and the learned skip s₀·x + s₁·y. The port keeps
the channels-first layout (B, C, H, W) and the JAX operand names: scale (C,),
w1 (C, 2H), dwk (3, 3, 2H), w2 (H, C), skip (2,). A block of ``nsubnets``
> 1 (JAX runs such blocks outside its kernel) comes with w1 and w2 as the
dense block-diagonal matrices of its grouped expand and project
(``models/blocks.gated_params``) and normalizes over each subnet's
C / nsubnets channels; every kernel takes the count at run time, so no
instance is added (the wgmma kernel: two more passes over the region's x
from global memory in plain loops, so the registers the one-subnet norm
holds are not added to; partial sums per subnet and thread in its expand
buffer; runs of a multiple of 8 channels, ``gated_subnets_ok``).

Rounding in bf16, where the TPU kernels round: the normalized input y0 before
the expand and the gate output y3 before the project; the expand, the taps,
the gate and the skip stay f32; the output is rounded once.

On the card, in bf16 (the served dtype; ``kernels/csrc/gated_block.cu``):
one CTA per output tile of up to 128 pixels (64 at C = 384) and a 1-pixel
halo: two consumer warpgroups and a producer warpgroup. The consumers load
x's region from global memory straight into registers, one to four threads
per pixel, normalize it and write y0 (the region's pixels × C) once into
shared memory in wgmma's swizzled K-major layout. The hidden dimension is
walked in chunks of hc = 32 m-channels and their 32 u-channels, whose
weights the producer brings in by TMA, into two rings of 2 slots under
mbarriers, a chunk ahead. Per chunk, the next chunk's expand is
queued on the tensor cores first (``wgmma``, transposed: the chunk's 64
hidden rows are M and the region's pixels N, m64n96k16 per warpgroup, or
m64n32k16 at C = 384; f32 into shared memory). Then come the taps and gate
on the CUDA cores in f32 and y3 rounded to bf16 in shared memory. The
project (``wgmma`` m64n64k16/m64n32k16) adds into an accumulator that
stays in registers across the whole hidden loop, so the activation never
round-trips through shared memory; the epilogue writes s₀·x + s₁·acc once.
C is one of 96, 128, 192, 384 and H a multiple of 32 (every block the
flagship, lite, micro and the ablation heads serve on K4); anything else
raises. ``plan_gated_tiles`` picks the tile.

In f32 (not served; the f32 model check), and for the K3 calls that
``ops/block_stack.stack_route`` sends there (lite's C = 24, and f32), the
block kernel of ``kernels/csrc/block_stack.cu`` (K = 1 here): one CTA per
output tile of (tile_h, tile_w) pixels with a K-pixel halo, the f32
activation in shared memory, the hidden dimension in chunks of hc, the 1×1
products as f32 FMAs on the CUDA cores (``mma.sync`` in bf16). Per pixel a block needs
3·C·2H tensor operations and about 21·2H + 8·C CUDA-core operations
against 4·C bytes (bf16 in and out), so it is bound by operations: by the
CUDA-core taps and gate at C ≤ 96 and by the products at C ≥ 192. The halo
is recomputed by each tile, and the weights are staged into shared memory
by every CTA, which is the price of keeping each block's activation on
chip; ``plan_tiles`` weighs the halo against the number of waves of CTAs on
the 132 SMs, ``plan_gated_tiles`` likewise for the wgmma kernel.

Boundaries: the taps read the region through a clamp to its own bounds. At
an image edge the region's edge is the image's, so the clamp is the
reference's replicate padding of the derived activation itself; at an
interior edge the clamped reads are wrong, and the error moves one pixel
inward per block, so after K blocks it has not reached the tile.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import check_status, dtype_code, kernel_library, refuse_grad

EPS = 1e-5
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
NUM_SMS = 132        # H100 SXM
TILE_SIZES = (2, 4, 8, 12, 16, 24, 32)  # tile heights and widths the plan tries
GATED_CHANNELS = (96, 128, 192, 384)  # the C that the wgmma kernel is built for
GATED_HC = 32  # hidden channels per chunk of the wgmma kernel
GATED_TILE_SIZES = (2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 32)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor to ``dtype`` and back (identity in f32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def subnet_norm(x, nsubnets=1):
    """CustomLayerNorm without its scale: x (B, C, H, W) f32 divided by
    sqrt(var + 1e-5), the unbiased variance over each subnet's C / nsubnets
    channels (a pixel's channels in ``nsubnets`` runs), the mean not
    subtracted."""
    b, c, h, w = x.shape
    xg = x.reshape(b, nsubnets, c // nsubnets, h, w)
    mean = xg.mean(dim=2, keepdim=True)
    var = ((xg - mean) ** 2).sum(dim=2, keepdim=True) / (c // nsubnets - 1)
    return (xg / torch.sqrt(var + EPS)).reshape(b, c, h, w)


def block_f32(x, scale, w1, dwk, w2, skip, dtype, nsubnets=1):
    """One block on an f32 activation x (B, C, H, W), rounding y0 and y3 to
    ``dtype``; returns the f32 result, unrounded. ``nsubnets``: the norm's
    subnets (``subnet_norm``); w1 and w2 are dense (block-diagonal for a
    grouped block, ``models/blocks.gated_params``)."""
    b, c, h, w = x.shape
    y0 = _round(subnet_norm(x, nsubnets) * scale.float().reshape(1, c, 1, 1), dtype)
    y1 = torch.einsum("bchw,co->bohw", y0, w1.to(dtype).float())
    y1p = F.pad(y1, (1, 1, 1, 1), mode="replicate")
    dw = dwk.float()
    acc = sum(y1p[:, :, a:a + h, bb:bb + w] * dw[a, bb].reshape(1, -1, 1, 1)
              for a in range(3) for bb in range(3))
    m, u = acc.chunk(2, dim=1)
    y3 = _round(torch.sigmoid(m) * m * u, dtype)
    y4 = torch.einsum("bhxy,hc->bcxy", y3, w2.to(dtype).float())
    sk = skip.float()
    return sk[0] * x + sk[1] * y4


def gated_block_plain(x, scale, w1, dwk, w2, skip, nsubnets=1):
    """The block in plain PyTorch: f32 compute, bf16 rounding where the
    kernel rounds, output in x's dtype."""
    return block_f32(x.float(), scale, w1, dwk, w2, skip, x.dtype, nsubnets).to(x.dtype)


def smem_bytes(c: int, hc: int, nrp: int, esize: int) -> int:
    """Shared memory of one CTA, as the kernel lays it out, with the channels
    padded to Cp, C rounded up to 16: in f32 the activation (Cp, ldx), the
    expand chunk (2hc, ldx) and its taps (9, 2hc), with ldx the region's nrp
    pixels padded to 8 mod 32; then in the working type y0 (nrp, Cp + pad),
    y3 (nrp, hc + pad), the expand weights (2hc, Cp + pad) and the project
    weights (Cp, hc + pad); each part 16-byte aligned."""
    c = -(-c // 16) * 16
    pad = 8 if esize == 2 else 1
    ldx = nrp + (8 - nrp) % 32

    def seg(n):
        return -(-n // 16) * 16

    return (seg(4 * c * ldx) + seg(4 * 2 * hc * ldx) + seg(4 * 9 * 2 * hc)
            + seg(esize * nrp * (c + pad))
            + seg(esize * nrp * (hc + pad)) + seg(esize * 2 * hc * (c + pad))
            + seg(esize * c * (hc + pad)))


@functools.lru_cache(maxsize=None)
def plan_tiles(b: int, c: int, hidden: int, h: int, w: int, n_blocks: int,
               esize: int) -> tuple[int, int, int, int]:
    """(tile_h, tile_w, hc, smem bytes) for a launch. A CTA takes a whole SM
    (its shared memory), so the launch runs in ceil(CTAs / 132) waves, and a
    CTA's time grows with its region's padded pixels nrp and its number of
    hidden chunks H / hc. Of the plans that fit in shared memory, the one with
    the least waves × (nrp + H / hc) wins, on a tie the larger hc. This cost
    picked the fastest plan, or one within 5 % of it, at the flagship's K3
    shapes of the 512x512 and 480x320 requests in a sweep of every fitting
    plan on the H100, while they ran on this kernel (before the wgmma stack
    kernel). Raises if nothing fits."""
    hcs = [v for v in ((32, 16, 8) if esize == 4 else (32, 16)) if hidden % v == 0]
    best = None
    for th in TILE_SIZES:
        for tw in TILE_SIZES:
            nrp = -(-min(th + 2 * n_blocks, h) * min(tw + 2 * n_blocks, w) // 16) * 16
            waves = -(-b * -(-h // th) * -(-w // tw) // NUM_SMS)
            for hc in hcs:
                smem = smem_bytes(c, hc, nrp, esize)
                if smem <= SMEM_LIMIT:
                    key = (waves * (nrp + hidden // hc), -hc)
                    if best is None or key < best[0]:
                        best = (key, (th, tw, hc, smem))
                    break
    if best is None:
        raise ValueError(f"no tile of the block kernel fits C={c}, hidden={hidden}, "
                         f"K={n_blocks} in {SMEM_LIMIT} bytes of shared memory")
    return best[1]


def _align1k(n: int) -> int:
    return -(-n // 1024) * 1024


def gated_smem_bytes(c: int, mr: int, mp: int) -> int:
    """Shared memory of one CTA of the wgmma kernel, as it lays it out: y0
    (mr, C) bf16 in 64-channel blocks; two rings of 2 slots, one of
    a chunk's expand weights (64 rows by each 64-channel block, 128 bytes a
    row), one of its project weights (C rows of hc = 32 bf16); the f32
    expand chunk (mr, 64 + 8); y3 (mp, 32) bf16; each part 1024-byte
    aligned, then the rings' 8 mbarriers and 1024 bytes to align the
    base."""
    kb = -(-c // 64)
    return (_align1k(kb * mr * 128) + 2 * (kb * 64 * 128 + _align1k(c * GATED_HC * 2))
            + _align1k(mr * 72 * 4) + _align1k(mp * GATED_HC * 2) + 4 * 2 * 8 + 1024)


@functools.lru_cache(maxsize=None)
def plan_gated_tiles(b: int, c: int, hidden: int, h: int, w: int
                     ) -> tuple[int, int, int, int, int, int]:
    """(tile_h, tile_w, hc, mr, mp, smem bytes) for the wgmma kernel.
    A tile has at most mp output pixels (128 for C ≤ 192, where each
    warpgroup holds 64 rows of the project; 64 at C = 384, where the two
    split its columns) and its region, the tile plus a 1-pixel halo, at
    most mr pixels: the expand's rows, 192 (64 at C = 384), fixed when the
    kernel is compiled (ptxas serializes a wgmma behind a runtime branch).
    One CTA takes an SM and its time is a part fixed by mr (the norm and the
    expand, about 8 tap steps' worth) and the taps, whose steps a thread
    walks one after another: ceil(tw / 8) columns by ceil(th / 2) row pairs.
    So the plan with the least waves × (8 + tap steps) wins, then the fewer
    CTAs (each reads all the weights). This cost
    picks the fastest plan, or one within 5 % of it, at each K4 shape of the
    512x512 and 480x320 requests in a sweep of every plan that fits on the
    H100 (``python -m irdu_tpu_torch.kernels.plan_sweep``). Raises if C or
    the hidden width is not one the kernel takes."""
    if c not in GATED_CHANNELS or hidden % GATED_HC:
        raise ValueError(f"the wgmma block kernel takes C in {GATED_CHANNELS} and H a "
                         f"multiple of {GATED_HC}, got C={c}, H={hidden}")
    best = None
    for th, tw, mr, mp, smem in gated_plans(c, h, w):
        tiles = b * -(-h // th) * -(-w // tw)
        steps = -(-tw // 8) * -(-th // 2)
        key = (-(-tiles // NUM_SMS) * (8 + steps), tiles)
        if best is None or key < best[0]:
            best = (key, (th, tw, GATED_HC, mr, mp, smem))
    return best[1]


def gated_plans(c: int, h: int, w: int):
    """Every (tile_h, tile_w, mr, mp, smem) the wgmma kernel takes at C on
    an h x w plane: tiles from GATED_TILE_SIZES whose pixels fit mp and
    region fits mr (the shared memory is the same for all of them)."""
    mp, mr = (64, 64) if c > 192 else (128, 192)
    smem = gated_smem_bytes(c, mr, mp)
    for th in GATED_TILE_SIZES:
        for tw in GATED_TILE_SIZES:
            if th * tw <= mp and min(th + 2, h) * min(tw + 2, w) <= mr:
                yield th, tw, mr, mp, smem


def launch_gated(x, scale, w1, dwk, w2, skip, nsubnets=1):
    """One block over a bf16 x (B, C, H, W) on the wgmma kernel, operands in
    the JAX layouts: scale (C,), w1 (C, 2H), dwk (3, 3, 2H), w2 (H, C),
    skip (2,). w1 and w2 bf16 (read as w1ᵀ and w2ᵀ rows by TMA: the conv
    layout the model serves needs no copy); scale, dwk and skip of one dtype,
    f32 or bf16; ``nsubnets`` the norm's subnets, runs of C / nsubnets
    channels, a multiple of 8 (``gated_subnets_ok``). Raises on what the
    kernel does not take."""
    if not x.is_contiguous() or x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError("the wgmma block kernel needs a contiguous bf16 CUDA x")
    b, c, h, w = x.shape
    hidden = w2.shape[0]
    th, tw, _, _, _, _ = plan_gated_tiles(b, c, hidden, h, w)
    if not gated_subnets_ok(c, nsubnets):
        raise ValueError(f"the wgmma block kernel takes subnets of a multiple of 8 channels "
                         f"(at most 8 at C = 384), got C={c}, nsubnets={nsubnets}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"fused_gated_block: w1 and w2 must be in x's dtype {x.dtype}")
    if (not (scale.dtype == dwk.dtype == skip.dtype)
            or scale.dtype not in (torch.float32, torch.bfloat16)
            or not (scale.is_contiguous() and skip.is_contiguous())):
        raise ValueError("fused_gated_block: scale, dwk and skip must share one dtype, f32 "
                         "or bf16, scale and skip contiguous")
    if any(t.device != x.device for t in (scale, w1, dwk, w2, skip)):
        raise ValueError(f"fused_gated_block: every operand must be on {x.device}")
    w1t, w2t = _unit_stride(w1.t(), 1), _unit_stride(w2.t(), 1)
    d9 = dwk.reshape(9, -1)
    out = torch.empty_like(x)
    lib = kernel_library()
    status = lib.irdu_gated_block(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), w1t.data_ptr(), d9.data_ptr(),
        w2t.data_ptr(), skip.data_ptr(), b, c, h, w, hidden, w1t.stride(0), w2t.stride(0),
        *d9.stride(), th, tw, dtype_code(scale.dtype), nsubnets,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        detail = lib.irdu_gated_block_error().decode()
        raise RuntimeError(f"fused_gated_block: CUDA error {status} "
                           f"({lib.irdu_error_string(status).decode()}) {detail}".rstrip())
    return out


def gated_subnets_ok(c: int, nsubnets: int) -> bool:
    """Whether the wgmma kernel's norm takes ``nsubnets`` at C: runs of a
    multiple of 8 channels (an 8-channel group of a thread lies in one), and
    the partial sums of two passes (2·nsubnets·256 f32) beside the scale in
    its expand buffer Y1 (``gated_smem_bytes``)."""
    mr = 64 if c > 192 else 192
    return c % nsubnets == 0 and (c // nsubnets) % 8 == 0 and c + 512 * nsubnets <= mr * 72


def launch_blocks(kernel: str, x, scale, w1, dwk, w2, skip, nsubnets=1):
    """Run K blocks over x (B, C, H, W) on the card, with the operands stacked
    over K in the JAX per-block layouts: scale (K, C), w1 (K, C, 2H),
    dwk (K, 9, 2H), w2 (K, H, C), skip (K, 2); w1, dwk and w2 may be strided
    views. ``kernel`` names the caller in errors.

    What the kernel takes: x contiguous f32 or bf16 with C a multiple of 8
    (the kernel pads C ≡ 8 mod 16 to 16 in shared memory, the lite model's
    C = 24); w1 and w2 in x's dtype with H a multiple of 16; scale, dwk and skip of one
    dtype (f32, or bf16 with bf16 x), contiguous scale and skip; ``nsubnets``
    the norm's subnets, runs of an even number of channels."""
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"{kernel} needs a contiguous CUDA or CPU tensor")
    b, c, h, w = x.shape
    k, hidden = w2.shape[0], w2.shape[1]
    if c % 8 or hidden % 16:
        raise ValueError(f"{kernel}: the kernel takes C in multiples of 8 and H in "
                         f"multiples of 16, got C={c}, H={hidden}")
    if c % nsubnets or (c // nsubnets) % 2:
        raise ValueError(f"{kernel}: the kernel takes subnets of an even number of channels, "
                         f"got C={c}, nsubnets={nsubnets}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"{kernel}: w1 and w2 must be in x's dtype {x.dtype}")
    if (not (scale.dtype == dwk.dtype == skip.dtype)
            or scale.dtype not in (torch.float32, x.dtype)
            or not (scale.is_contiguous() and skip.is_contiguous())):
        raise ValueError(f"{kernel}: scale, dwk and skip must share one dtype, f32 or "
                         "x's, scale and skip contiguous")
    if any(t.device != x.device for t in (scale, w1, dwk, w2, skip)):
        raise ValueError(f"{kernel}: every operand must be on {x.device}")
    # the kernel copies bf16 weights 16 bytes at a time along C (w1) and H (w2)
    w1, w2 = _unit_stride(w1, 1), _unit_stride(w2, 1)
    th, tw, hc, _ = plan_tiles(b, c, hidden, h, w, k, x.element_size())
    out = torch.empty_like(x)
    status = kernel_library().irdu_block_stack(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), w1.data_ptr(),
        dwk.data_ptr(), w2.data_ptr(), skip.data_ptr(), b, c, h, w, k, hidden,
        *w1.stride(), *dwk.stride(), *w2.stride(), th, tw, hc,
        dtype_code(x.dtype), dtype_code(scale.dtype), nsubnets,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_status(kernel, status)
    return out


def _unit_stride(t, dim):
    """t itself when dimension ``dim`` has unit stride and the other strides
    and the address are 16-byte multiples, else a copy laid out so (the
    model's conv weights and the packed stacks already are)."""
    if t.stride(dim) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for d, st in enumerate(t.stride()) if d != dim):
        return t
    return t.movedim(dim, -1).contiguous().movedim(-1, dim)


def _check(x, scale, w1, dwk, w2, skip, nsubnets):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if nsubnets < 1 or c % nsubnets or c // nsubnets < 2:
        raise ValueError(f"nsubnets={nsubnets} must split C={c} into runs of 2 or more")
    hidden = w1.shape[-1] // 2
    for name, t, shape in (("scale", scale, (c,)), ("w1", w1, (c, 2 * hidden)),
                           ("dwk", dwk, (3, 3, 2 * hidden)), ("w2", w2, (hidden, c)),
                           ("skip", skip, (2,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def fused_gated_block(x, scale, w1, dwk, w2, skip, *, nsubnets=1):
    """One LocalNonLinearBlock over x (B, C, H, W): scale (C,), w1 (C, 2H),
    dwk (3, 3, 2H), w2 (H, C), skip (2,); ``nsubnets`` the norm's subnets
    (w1 and w2 then block-diagonal, dense). Returns x's shape and dtype.

    A CPU tensor takes the plain version; a bf16 CUDA tensor launches the
    wgmma kernel (what it takes: ``launch_gated``), an f32 one the block
    kernel's CUDA-core path (``launch_blocks``), or they raise."""
    refuse_grad("fused_gated_block", x, scale, w1, dwk, w2, skip)
    _check(x, scale, w1, dwk, w2, skip, nsubnets)
    run = _OP if library.tracing() else _run
    return run(x, scale, w1, dwk, w2, skip, nsubnets)


def _run(x, scale, w1, dwk, w2, skip, nsubnets):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        return gated_block_plain(x, scale, w1, dwk, w2, skip, nsubnets)
    if x.dtype == torch.bfloat16:
        out = launch_gated(x, scale, w1, dwk, w2, skip, nsubnets)
    else:
        out = launch_blocks("fused_gated_block", x, scale[None], w1[None],
                            dwk.reshape(1, 9, -1), w2[None], skip[None], nsubnets)
    fused_gated_block.launches += 1
    return out


fused_gated_block.launches = 0
_OP = library.define(
    "fused_gated_block(Tensor x, Tensor scale, Tensor w1, Tensor dwk, Tensor w2, "
    "Tensor skip, int nsubnets) -> Tensor", _run, lambda x, *rest: x.new_empty(x.shape))
