"""K3: up to four consecutive LocalNonLinearBlocks in one pass, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/block_stack.py:fused_block_stack``
(body ``_kernel``): K blocks over x (B, C, H, W) with the activation kept on
chip between them, in f32, and rounded only at the end. The operands are the
JAX package's stacked ones (``pack_block_params``): scales (K, C, 1) f32,
w1t (K, 2H, C), dwk (K, 9, 2H, 1) f32 with tap t = a·3 + b, w2t (K, C, H),
skips (K, 2) f32.

On the card, a call takes one of two kernels, by a rule of shapes decided
before any launch (``stack_route``):

- bf16 x with C in 16, 32, 48, 64 and H a multiple of 32 up to 128 (the
  flagship's C = 48, H = 96; lite's scale 1; micro; the split ablation heads)
  runs on ``kernels/csrc/block_stack_wgmma.cu``: one persistent cooperative
  launch whose K phases run one block each over every output tile, with grid
  barriers between them. Between blocks the f32 activation goes to two
  channels-last scratch buffers (ping-pong, allocated here: a pixel's C
  values contiguous, read and written 16 and 8 bytes at a time); phase 0
  reads bf16 x and the last phase writes bf16 out, so nothing rounds in
  between. Each block then needs only a 1-pixel halo, and runs K4's wgmma
  body (``gated_block.cu``: the expand transposed on wgmma, the f32 taps and
  gate, the project into a register accumulator) on 8x16-pixel tiles; block
  k's weights are loaded into shared memory by TMA once per phase.
- everything else (lite's C = 24, H = 48; f32) runs on the block kernel of
  ``ops/gated_block.py`` (``kernels/csrc/block_stack.cu``) with K blocks:
  each CTA loads its tile with a K-pixel halo once, runs the K blocks on it
  in shared memory and writes the tile once.

Per pixel and block the work is 3·C·2H tensor-core and 21·2H + 8·C CUDA-core
operations against 4·C bytes in and out per call (C = 48: 4,416 CUDA-core
operations a pixel and block), so K3 is bound by the CUDA-core taps and
gate; the wgmma kernel adds 28 bytes a pixel and channel of scratch traffic
at K = 4, which stays under that bound.

Grouped blocks (``nsubnets`` > 1) take block-diagonal w1t and w2t and the
subnet count at run time: each kernel normalizes over runs of C / nsubnets
channels (the wgmma kernel by masked passes over the registers it holds a
pixel's channels in, after its one-subnet statistics are skipped;
``block_stack.cu`` by a loop over the runs).

Every block pads its own input by replicating edges, as
``block_stack_reference`` does; both kernels get this at all four image
edges from their clamped tap reads (see ``ops/gated_block.py``). The TPU
kernel's eligibility rules (``stack_ok``: W % 128, the VMEM-sized
``_pick_tile``) are TPU lane and memory facts and are not copied.

``dw_mxu=True`` (keyword-only, off by default as in JAX; no model passes it)
is JAX's fold of the expand into the depthwise taps: the tap matrices
m9[k, t] = w1ᵀ[k] ⊙ dwk[k, t] (``pack_dw_taps``: the f32 product rounded to
x's dtype) and, per block, nine products of the replicate-padded y0 (rounded
to x's dtype) shifted by each tap against m9[t], accumulated in f32, then the
gate, the project and the skip (``block_stack_dw_mxu_plain``). In bf16 at
the shapes of the wgmma stack kernel it runs on
``kernels/csrc/block_stack_dw_mxu.cu`` (the nine tap products per hidden
chunk on wgmma with y0 from registers, ``launch_dw_mxu``): 9·2·C·2H
tensor-core operations a pixel and block against the served kernel's 3·C·2H
and 21·2H CUDA-core operations, so at C = 48 its bound is above K3's, as it
was slower than the tap path on the TPU; it stays off every served path. An
f32 call takes ``block_stack.cu``, the same function with the expand and the
taps apart (no tensor-core route in f32); a bf16 call at another shape, or
with ``nsubnets`` > 1 (JAX's kernel takes no subnets), raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import kernel_library, refuse_grad
from irdu_tpu_torch.ops.gated_block import (GATED_HC, GATED_TILE_SIZES, NUM_SMS,
                                            SMEM_LIMIT, _round, block_f32, launch_blocks,
                                            subnet_norm)

STACK_CHANNELS = (16, 32, 48, 64)  # the C the wgmma stack kernel is built for
STACK_MAX_HIDDEN = 128  # its weight chunks: H / 32 ≤ 4
STACK_MR, STACK_MP = 192, 128  # region pixels (expand rows), tile pixels (project rows)


def pack_block_params(params_list, dtype):
    """Per-block dicts {scale (C,), w1 (C, 2H), dwk (3, 3, 2H), w2 (H, C),
    skip (2,)} → (scales, w1t, dwk, w2t, skips), the stacked operands."""
    scales = torch.stack([p["scale"].float()[:, None] for p in params_list])
    w1t = torch.stack([p["w1"].to(dtype).t() for p in params_list])
    dwk = torch.stack([p["dwk"].float().reshape(9, -1)[:, :, None] for p in params_list])
    w2t = torch.stack([p["w2"].to(dtype).t() for p in params_list])
    skips = torch.stack([p["skip"].float() for p in params_list])
    return scales, w1t, dwk, w2t, skips


def block_stack_plain(x, scales, w1t, dwk, w2t, skips, nsubnets=1):
    """The K blocks in plain PyTorch, one after another, each padding its own
    input; the activation stays f32 between them (y0 and y3 rounded to x's
    dtype) and the output is rounded once. ``nsubnets``: the norm's subnets
    (``gated_block.subnet_norm``)."""
    xf = x.float()
    for k in range(w1t.shape[0]):
        xf = block_f32(xf, scales[k, :, 0], w1t[k].t(), dwk[k, :, :, 0].reshape(3, 3, -1),
                       w2t[k].t(), skips[k], x.dtype, nsubnets)
    return xf.to(x.dtype)


def pack_dw_taps(w1t, dwk, dtype):
    """The tap matrices m9 (K, 9, 2H, C) = w1ᵀ[k] ⊙ dwk[k, t]: the expand
    folded into each depthwise tap, the product in f32 rounded to ``dtype``
    (JAX's ``fused_block_stack`` packs them so)."""
    return (w1t.float()[:, None] * dwk.float()).to(dtype)


def block_stack_dw_mxu_plain(x, scales, w1t, dwk, w2t, skips):
    """The K blocks with the expand folded into the taps, in plain PyTorch:
    per block y0 rounded to x's dtype, nine f32-accumulated products of the
    replicate-padded y0 shifted by tap t = a·3 + b against m9[t], then the
    gate (y3 rounded), the project and the skip; the activation f32 between
    blocks, the output rounded once."""
    dtype = x.dtype
    m9 = pack_dw_taps(w1t, dwk, dtype).float()
    xf = x.float()
    _, c, h, w = x.shape
    for k in range(w1t.shape[0]):
        y0 = _round(subnet_norm(xf) * scales[k, :, 0].float().reshape(1, c, 1, 1), dtype)
        y0p = F.pad(y0, (1, 1, 1, 1), mode="replicate")
        acc = sum(torch.einsum("oc,bchw->bohw", m9[k, a * 3 + b], y0p[:, :, a:a + h, b:b + w])
                  for a in range(3) for b in range(3))
        m, u = acc.chunk(2, dim=1)
        y3 = _round(torch.sigmoid(m) * m * u, dtype)
        y4 = torch.einsum("bhxy,ch->bcxy", y3, w2t[k].to(dtype).float())
        sk = skips[k].float()
        xf = sk[0] * xf + sk[1] * y4
    return xf.to(dtype)


def stack_route(dtype, c: int, hidden: int) -> str:
    """The kernel a CUDA call of K3 runs on: "wgmma" (``block_stack_wgmma.cu``)
    for bf16 x with C in STACK_CHANNELS and H a multiple of 32 up to
    STACK_MAX_HIDDEN, else "block_stack" (``block_stack.cu``)."""
    if (dtype == torch.bfloat16 and c in STACK_CHANNELS and hidden % GATED_HC == 0
            and 0 < hidden <= STACK_MAX_HIDDEN):
        return "wgmma"
    return "block_stack"


def stack_smem_bytes(c: int, hidden: int) -> int:
    """Shared memory of one CTA of the wgmma stack kernel, as it lays it
    out: y0 (192 region pixels, 64 channels) bf16; each of the H / 32 weight
    chunks' w1ᵀ rows (64 by 64 channels) and w2ᵀ rows (C by 32 hidden) bf16;
    the f32 expand chunk (192, 64 + 8); y3 (128, 32) bf16; the tile's f32
    input (128, C + 4); each part 1024-byte aligned, then 4 mbarriers and
    1024 bytes to align the base."""
    def a1k(n):
        return -(-n // 1024) * 1024
    nch = hidden // GATED_HC
    return (a1k(STACK_MR * 128) + nch * (8192 + a1k(c * GATED_HC * 2))
            + a1k(STACK_MR * 72 * 4) + a1k(STACK_MP * GATED_HC * 2)
            + a1k(STACK_MP * (c + 4) * 4) + 4 * 8 + 1024)


@functools.lru_cache(maxsize=None)
def plan_stack_tiles(b: int, c: int, hidden: int, h: int, w: int) -> tuple[int, int, int]:
    """(tile_h, tile_w, smem bytes) for the wgmma stack kernel. A tile has at
    most 128 pixels and its region (a 1-pixel halo) at most 192. One CTA per
    SM walks ceil(tiles / 132) tiles a phase, each costing a part fixed by
    the region (the norm and the expand, about 8 tap steps) and the taps,
    ceil(tw / 16) column pairs by ceil(th / 2) row pairs a thread: the plan
    with the least ceil(tiles / 132) × (8 + tap steps) wins, then the fewer
    tiles (K4's cost, ``gated_block.plan_gated_tiles``, for this kernel's
    tap loop). Raises on a shape the kernel does not take."""
    if stack_route(torch.bfloat16, c, hidden) != "wgmma":
        raise ValueError(f"the wgmma stack kernel takes C in {STACK_CHANNELS} and H a "
                         f"multiple of {GATED_HC} up to {STACK_MAX_HIDDEN}, got C={c}, H={hidden}")
    best = None
    for th in GATED_TILE_SIZES:
        for tw in GATED_TILE_SIZES:
            if th * tw > STACK_MP or min(th + 2, h) * min(tw + 2, w) > STACK_MR:
                continue
            tiles = b * -(-h // th) * -(-w // tw)
            key = (-(-tiles // NUM_SMS) * (8 + -(-tw // 16) * -(-th // 2)), tiles)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    smem = stack_smem_bytes(c, hidden)
    assert smem <= SMEM_LIMIT
    return (*best[1], smem)


def stack_scratch_planes(k: int) -> int:
    """f32 scratch buffers of x's size (channels-last) a K-block call needs:
    block k writes buffer k mod 2 for k < K - 1 (ping-pong), so 0, 1 or 2."""
    return min(k - 1, 2)


def launch_stack(x, scales, w1t, dwk, w2t, skips, nsubnets=1):
    """K blocks over a bf16 x (B, C, H, W) on the wgmma stack kernel, with
    the stacked operands of ``pack_block_params``: w1t (K, 2H, C) and w2t
    (K, C, H) bf16, scales (K, C, 1), dwk (K, 9, 2H, 1) and skips (K, 2)
    f32, all contiguous (copied if not); ``nsubnets`` the norm's subnets.
    Raises on what the kernel does not take."""
    if not x.is_contiguous() or x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError("the wgmma stack kernel needs a contiguous bf16 CUDA x")
    b, c, h, w = x.shape
    k, hidden = w2t.shape[0], w2t.shape[2]
    th, tw, _ = plan_stack_tiles(b, c, hidden, h, w)
    if w1t.dtype != torch.bfloat16 or w2t.dtype != torch.bfloat16:
        raise ValueError("fused_block_stack: w1t and w2t must be bf16")
    if any(t.dtype != torch.float32 for t in (scales, dwk, skips)):
        raise ValueError("fused_block_stack: scales, dwk and skips must be f32")
    if any(t.device != x.device for t in (scales, w1t, dwk, w2t, skips)):
        raise ValueError(f"fused_block_stack: every operand must be on {x.device}")
    w1t, w2t, scales, dwk, skips = (t.contiguous() for t in (w1t, w2t, scales, dwk, skips))
    out = torch.empty_like(x)
    n_scr = stack_scratch_planes(k)
    scratch = torch.empty((n_scr, *x.shape), dtype=torch.float32, device=x.device) if n_scr else None
    lib = kernel_library()
    status = lib.irdu_block_stack_wgmma(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr() if n_scr else None, scales.data_ptr(),
        w1t.data_ptr(), dwk.data_ptr(), w2t.data_ptr(), skips.data_ptr(), b, c, h, w, k, hidden,
        th, tw, nsubnets, torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        detail = lib.irdu_block_stack_wgmma_error().decode()
        raise RuntimeError(f"fused_block_stack: CUDA error {status} "
                           f"({lib.irdu_error_string(status).decode()}) {detail}".rstrip())
    return out


def dw_mxu_smem_bytes(c: int, hidden: int) -> int:
    """Shared memory of one CTA of the dw_mxu kernel, as it lays it out: y0
    (192 region pixels, 64 channels) bf16; two slots of a chunk's nine tap
    matrices (64 rows by 64 channels, bf16); each of the H / 32 chunks' w2ᵀ
    rows (C by 32 hidden) bf16; y3 (128, 32) bf16; 64 f32 norm scales and 3
    mbarriers, then 1024 bytes to align the base."""
    def a1k(n):
        return -(-n // 1024) * 1024
    return (a1k(STACK_MR * 128) + 2 * 9 * 8192 + hidden // GATED_HC * a1k(c * GATED_HC * 2)
            + STACK_MP * GATED_HC * 2 + 64 * 4 + 3 * 8 + 1024)


def launch_dw_mxu(x, scales, w1t, dwk, w2t, skips):
    """K blocks over a bf16 x (B, C, H, W) on the dw_mxu kernel, with the
    stacked operands (``launch_stack``'s) and the tap matrices packed here;
    the tile is ``plan_stack_tiles``'. Raises on what the kernel does not
    take."""
    if not x.is_contiguous() or x.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError("the dw_mxu kernel needs a contiguous bf16 CUDA x")
    b, c, h, w = x.shape
    k, hidden = w2t.shape[0], w2t.shape[2]
    th, tw, _ = plan_stack_tiles(b, c, hidden, h, w)
    if any(t.device != x.device for t in (scales, w1t, dwk, w2t, skips)):
        raise ValueError(f"fused_block_stack: every operand must be on {x.device}")
    m9 = pack_dw_taps(w1t, dwk, torch.bfloat16).contiguous()
    w2t = w2t.to(torch.bfloat16).contiguous()
    scales, skips = (t.float().contiguous() for t in (scales, skips))
    out = torch.empty_like(x)
    n_scr = stack_scratch_planes(k)
    scratch = torch.empty((n_scr, *x.shape), dtype=torch.float32, device=x.device) if n_scr else None
    lib = kernel_library()
    status = lib.irdu_block_stack_dw_mxu(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr() if n_scr else None, scales.data_ptr(),
        m9.data_ptr(), w2t.data_ptr(), skips.data_ptr(), b, c, h, w, k, hidden, th, tw,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        detail = lib.irdu_block_stack_dw_mxu_error().decode()
        raise RuntimeError(f"fused_block_stack(dw_mxu=True): CUDA error {status} "
                           f"({lib.irdu_error_string(status).decode()}) {detail}".rstrip())
    return out


def _check(x, scales, w1t, dwk, w2t, skips, nsubnets):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if nsubnets < 1 or c % nsubnets or c // nsubnets < 2:
        raise ValueError(f"nsubnets={nsubnets} must split C={c} into runs of 2 or more")
    k, hidden2 = w1t.shape[0], w1t.shape[1]
    if not 1 <= k <= 4:
        raise ValueError(f"fused_block_stack runs 1 to 4 blocks, got {k}")
    for name, t, shape in (("scales", scales, (k, c, 1)), ("w1t", w1t, (k, hidden2, c)),
                           ("dwk", dwk, (k, 9, hidden2, 1)),
                           ("w2t", w2t, (k, c, hidden2 // 2)), ("skips", skips, (k, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def fused_block_stack(x, scales, w1t, dwk, w2t, skips, *, nsubnets=1, dw_mxu=False):
    """K ≤ 4 LocalNonLinearBlocks over x (B, C, H, W) with the stacked
    operands of ``pack_block_params``; ``nsubnets`` the norm's subnets (the
    blocks' w1 and w2 then block-diagonal, dense); ``dw_mxu`` the expand
    folded into the taps (see the module docstring). Returns x's shape and
    dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    that ``stack_route`` names (what each takes: ``launch_stack``,
    ``gated_block.launch_blocks``; with ``dw_mxu`` ``launch_dw_mxu`` in
    bf16) or raises."""
    refuse_grad("fused_block_stack", x, scales, w1t, dwk, w2t, skips)
    _check(x, scales, w1t, dwk, w2t, skips, nsubnets)
    if dw_mxu and nsubnets != 1:
        raise ValueError("dw_mxu runs blocks of one subnet (JAX's fused_block_stack takes "
                         f"no subnets), got nsubnets={nsubnets}")
    if dw_mxu and x.device.type != "cpu" and x.dtype != torch.float32 and stack_route(
            x.dtype, x.shape[1], w2t.shape[2]) != "wgmma":
        raise ValueError(f"fused_block_stack(dw_mxu=True) in {x.dtype} takes C in "
                         f"{STACK_CHANNELS} and H a multiple of {GATED_HC} up to "
                         f"{STACK_MAX_HIDDEN}, got C={x.shape[1]}, H={w2t.shape[2]}")
    run = _OP if library.tracing() else _run
    return run(x, scales, w1t, dwk, w2t, skips, nsubnets, dw_mxu)


def _run(x, scales, w1t, dwk, w2t, skips, nsubnets, dw_mxu=False):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        if dw_mxu:
            return block_stack_dw_mxu_plain(x, scales, w1t, dwk, w2t, skips)
        return block_stack_plain(x, scales, w1t, dwk, w2t, skips, nsubnets)
    if dw_mxu and x.dtype == torch.bfloat16:
        out = launch_dw_mxu(x, scales, w1t, dwk, w2t, skips)
        fused_block_stack.dw_mxu_launches += 1
        return out
    if stack_route(x.dtype, x.shape[1], w2t.shape[2]) == "wgmma":
        out = launch_stack(x, scales, w1t, dwk, w2t, skips, nsubnets)
    else:
        out = launch_blocks("fused_block_stack", x, scales[:, :, 0], w1t.transpose(1, 2),
                            dwk[:, :, :, 0], w2t.transpose(1, 2), skips, nsubnets)
    fused_block_stack.launches += 1
    return out


fused_block_stack.launches = 0
fused_block_stack.dw_mxu_launches = 0  # the dw_mxu kernel's (block_stack_dw_mxu.cu)
_OP = library.define(
    "fused_block_stack(Tensor x, Tensor scales, Tensor w1t, Tensor dwk, Tensor w2t, "
    "Tensor skips, int nsubnets, bool dw_mxu) -> Tensor", _run,
    lambda x, *rest: x.new_empty(x.shape))
