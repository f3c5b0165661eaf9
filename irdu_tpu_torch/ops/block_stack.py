"""K3: up to four consecutive LocalNonLinearBlocks in one pass, CHW.

Replaces the TPU kernel ``irdu_tpu/ops/pallas/block_stack.py:fused_block_stack``
(body ``_kernel``): K blocks over x (B, C, H, W) with the activation kept on
chip between them, in f32, and rounded only at the end. The operands are the
JAX package's stacked ones (``pack_block_params``): scales (K, C, 1) f32,
w1t (K, 2H, C), dwk (K, 9, 2H, 1) f32 with tap t = a·3 + b, w2t (K, C, H),
skips (K, 2) f32.

On the card it is the block kernel of ``ops/gated_block.py``
(``kernels/csrc/block_stack.cu``) with K blocks: each CTA loads its tile
with a K-pixel halo once, runs the K blocks on it in shared memory and
writes the tile once. Every block pads its own input by replicating edges,
as ``block_stack_reference`` does; the kernel gets this at all four image
edges from its clamped tap reads (see ``ops/gated_block.py``). The TPU
kernel's eligibility rules (``stack_ok``: W % 128, the VMEM-sized
``_pick_tile``) are TPU lane and memory facts and are not copied; what this
kernel takes is stated in ``gated_block.launch_blocks``. Its ``dw_mxu``
variant, the expand folded into nine matrix-unit tap products, computes the
same function and is not ported.
"""

from __future__ import annotations

import torch

from irdu_tpu_torch.ops.gated_block import block_f32, launch_blocks


def pack_block_params(params_list, dtype):
    """Per-block dicts {scale (C,), w1 (C, 2H), dwk (3, 3, 2H), w2 (H, C),
    skip (2,)} → (scales, w1t, dwk, w2t, skips), the stacked operands."""
    scales = torch.stack([p["scale"].float()[:, None] for p in params_list])
    w1t = torch.stack([p["w1"].to(dtype).t() for p in params_list])
    dwk = torch.stack([p["dwk"].float().reshape(9, -1)[:, :, None] for p in params_list])
    w2t = torch.stack([p["w2"].to(dtype).t() for p in params_list])
    skips = torch.stack([p["skip"].float() for p in params_list])
    return scales, w1t, dwk, w2t, skips


def block_stack_plain(x, scales, w1t, dwk, w2t, skips):
    """The K blocks in plain PyTorch, one after another, each padding its own
    input; the activation stays f32 between them (y0 and y3 rounded to x's
    dtype) and the output is rounded once."""
    xf = x.float()
    for k in range(w1t.shape[0]):
        xf = block_f32(xf, scales[k, :, 0], w1t[k].t(), dwk[k, :, :, 0].reshape(3, 3, -1),
                       w2t[k].t(), skips[k], x.dtype)
    return xf.to(x.dtype)


def _check(x, scales, w1t, dwk, w2t, skips):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    k, hidden2 = w1t.shape[0], w1t.shape[1]
    if not 1 <= k <= 4:
        raise ValueError(f"fused_block_stack runs 1 to 4 blocks, got {k}")
    for name, t, shape in (("scales", scales, (k, c, 1)), ("w1t", w1t, (k, hidden2, c)),
                           ("dwk", dwk, (k, 9, hidden2, 1)),
                           ("w2t", w2t, (k, c, hidden2 // 2)), ("skips", skips, (k, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def fused_block_stack(x, scales, w1t, dwk, w2t, skips):
    """K ≤ 4 LocalNonLinearBlocks over x (B, C, H, W) with the stacked
    operands of ``pack_block_params``. Returns x's shape and dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (what it takes: ``gated_block.launch_blocks``) or raises."""
    _check(x, scales, w1t, dwk, w2t, skips)
    if x.device.type == "cpu":
        return block_stack_plain(x, scales, w1t, dwk, w2t, skips)
    out = launch_blocks("fused_block_stack", x, scales[:, :, 0], w1t.transpose(1, 2),
                        dwk[:, :, :, 0], w2t.transpose(1, 2), skips)
    fused_block_stack.launches += 1
    return out


fused_block_stack.launches = 0
