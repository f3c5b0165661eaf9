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
``_pick_tile``) are TPU lane and memory facts and are not copied. Its
``dw_mxu`` variant, the expand folded into nine matrix-unit tap products,
computes the same function and is not ported.
"""

from __future__ import annotations

import functools

import torch

from irdu_tpu_torch.kernels import library
from irdu_tpu_torch.kernels.build import kernel_library, refuse_grad
from irdu_tpu_torch.ops.gated_block import (GATED_HC, GATED_TILE_SIZES, NUM_SMS, SMEM_LIMIT,
                                            block_f32, launch_blocks)

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


def fused_block_stack(x, scales, w1t, dwk, w2t, skips, *, nsubnets=1):
    """K ≤ 4 LocalNonLinearBlocks over x (B, C, H, W) with the stacked
    operands of ``pack_block_params``; ``nsubnets`` the norm's subnets (the
    blocks' w1 and w2 then block-diagonal, dense). Returns x's shape and
    dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    that ``stack_route`` names (what each takes: ``launch_stack``,
    ``gated_block.launch_blocks``) or raises."""
    refuse_grad("fused_block_stack", x, scales, w1t, dwk, w2t, skips)
    _check(x, scales, w1t, dwk, w2t, skips, nsubnets)
    run = _OP if library.tracing() else _run
    return run(x, scales, w1t, dwk, w2t, skips, nsubnets)


def _run(x, scales, w1t, dwk, w2t, skips, nsubnets):
    """The untraced call: the plain version on the CPU, else the launch."""
    if x.device.type == "cpu":
        return block_stack_plain(x, scales, w1t, dwk, w2t, skips, nsubnets)
    if stack_route(x.dtype, x.shape[1], w2t.shape[2]) == "wgmma":
        out = launch_stack(x, scales, w1t, dwk, w2t, skips, nsubnets)
    else:
        out = launch_blocks("fused_block_stack", x, scales[:, :, 0], w1t.transpose(1, 2),
                            dwk[:, :, :, 0], w2t.transpose(1, 2), skips, nsubnets)
    fused_block_stack.launches += 1
    return out


fused_block_stack.launches = 0
_OP = library.define(
    "fused_block_stack(Tensor x, Tensor scales, Tensor w1t, Tensor dwk, Tensor w2t, "
    "Tensor skips, int nsubnets) -> Tensor", _run, lambda x, *rest: x.new_empty(x.shape))
