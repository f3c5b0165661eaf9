"""Time every launch plan that fits in shared memory of the block kernels
at the block shapes of the 512x512 and 480x320 requests, in bf16 on one
CUDA card: K3 (``block_stack.cu``, scale 0) against ``gated_block.plan_tiles``,
K4 (the wgmma kernel ``gated_block.cu``, scales 1-3: every tile of
``gated_block.gated_plans``) against ``gated_block.plan_gated_tiles``:

    python -m irdu_tpu_torch.kernels.plan_sweep [--out sweep.json]

Prints, per shape, the fastest plan, the plan the planner picks and the
ratio of their times; --out keeps every timing. Inputs and weights are
seeded N(0, 1) draws at the flagship's widths.
"""

from __future__ import annotations

import argparse
import json
from unittest import mock

import torch

from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.ops.block_stack import fused_block_stack, pack_block_params


def _params(c, gen):
    h2 = 4 * c  # the flagship's hidden width is 2C, so 2H = 4C
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    return dict(scale=(rnd(c) * 0.1 + 1).bfloat16(),
                w1=(rnd(h2, c) / c ** 0.5).bfloat16().t(),  # the conv layout, as served
                dwk=(rnd(3, 3, h2) * 0.2).bfloat16(),
                w2=(rnd(c, h2 // 2) / (h2 / 2) ** 0.5).bfloat16().t(),
                skip=torch.tensor([1.0, 0.8], device="cuda").bfloat16())


def _ms(fn, reps=8):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(requests=((512, 512), (480, 320))):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, summary = [], []
    for h, w in requests:
        for s in range(4):
            c, hh, ww, k = 48 << s, h >> s, w >> s, 4 if s == 0 else 1
            x = torch.randn(1, c, hh, ww, device="cuda", generator=gen).bfloat16()
            shape = []
            if s == 0:  # K3: every tile and chunk of the block kernel
                packed = pack_block_params([_params(c, gen) for _ in range(4)], torch.bfloat16)
                def run():
                    return fused_block_stack(x, *packed)
                for th in gb.TILE_SIZES:
                    for tw in gb.TILE_SIZES:
                        nrp = -(-min(th + 2 * k, hh) * min(tw + 2 * k, ww) // 16) * 16
                        for hc in (32, 16):
                            smem = gb.smem_bytes(c, hc, nrp, 2)
                            if smem > gb.SMEM_LIMIT:
                                continue
                            with mock.patch.object(gb, "plan_tiles",
                                                   return_value=(th, tw, hc, smem)):
                                ms = _ms(run)
                            shape.append(dict(c=c, h=hh, w=ww, blocks=k, tile=[th, tw], hc=hc,
                                              nrp=nrp, ms=ms))
                th, tw, hc, _ = gb.plan_tiles(1, c, 2 * c, hh, ww, k, 2)
                picked = next(r for r in shape if r["tile"] == [th, tw] and r["hc"] == hc)
            else:  # K4: every tile of the wgmma kernel
                p = _params(c, gen)
                def run():
                    return gb.fused_gated_block(x, **p)
                for th, tw, mr, mp, smem in gb.gated_plans(c, hh, ww):
                    plan = (th, tw, gb.GATED_HC, mr, mp, smem)
                    with mock.patch.object(gb, "plan_gated_tiles", return_value=plan):
                        ms = _ms(run)
                    shape.append(dict(c=c, h=hh, w=ww, blocks=k, tile=[th, tw], ms=ms))
                th, tw, _, _, _, _ = gb.plan_gated_tiles(1, c, 2 * c, hh, ww)
                picked = next(r for r in shape if r["tile"] == [th, tw])
            rows += shape
            best = min(shape, key=lambda r: r["ms"])
            summary.append(dict(c=c, h=hh, w=ww, fastest=best, picked=picked,
                                ratio=picked["ms"] / best["ms"]))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.kernels.plan_sweep",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="write every timing to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep needs a CUDA card")
    rows, summary = sweep()
    for line in summary:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
