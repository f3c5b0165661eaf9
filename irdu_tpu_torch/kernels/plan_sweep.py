"""Time every launch plan of the block kernels at the block shapes of the
512x512 and 480x320 requests, in bf16 on one CUDA card: K3 (the wgmma stack
kernel ``block_stack_wgmma.cu``, scale 0: every tile of at most 128 pixels
whose region fits 192) against ``block_stack.plan_stack_tiles``, K4 (the
wgmma kernel ``gated_block.cu``, scales 1-3: every tile of
``gated_block.gated_plans``) against ``gated_block.plan_gated_tiles``; and
K2 (``edge_weights.cu``) at every call of the 512x512 flagship request and
the pixel model's diamond-12 call, every band of 1-64 rows by 2-8 threads a
row whose F planes fit ``edge_weights.EDGE_SMEM``, by device time
(``kernels/timing.py``), against ``edge_weights.plan_edge_tiles``; and K8
(``pixel_nhwc.cu``) at the 512x512 pixel request's segment, in each mode
and both tile plans (``pixel_nhwc.K8_PLANS``), by device time, against the
served plan (``K8_PLAN``):

    python -m irdu_tpu_torch.kernels.plan_sweep [--out sweep.json]

Prints, per shape, the fastest plan, the plan the planner picks and the
ratio of their times; --out keeps every timing. Inputs and weights are
seeded N(0, 1) draws at the flagship's widths. (K5 has one tile a window
and scale count, ``fused_step.k5_tile``: nothing to sweep.)
"""

from __future__ import annotations

import argparse
import json
from unittest import mock

import torch

from irdu_tpu_torch.kernels.timing import device_ms
from irdu_tpu_torch.ops import block_stack as bs
from irdu_tpu_torch.ops import edge_weights as ew
from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.ops import pixel_nhwc as pn
from irdu_tpu_torch.ops.windows import DIAMOND12


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
            if s == 0:  # K3: every tile of the wgmma stack kernel
                packed = bs.pack_block_params([_params(c, gen) for _ in range(4)],
                                              torch.bfloat16)
                def run():
                    return bs.fused_block_stack(x, *packed)
                smem = bs.stack_smem_bytes(c, 2 * c)
                for th in gb.GATED_TILE_SIZES:
                    for tw in gb.GATED_TILE_SIZES:
                        if (th * tw > bs.STACK_MP
                                or min(th + 2, hh) * min(tw + 2, ww) > bs.STACK_MR):
                            continue
                        with mock.patch.object(bs, "plan_stack_tiles",
                                               return_value=(th, tw, smem)):
                            ms = _ms(run)
                        shape.append(dict(c=c, h=hh, w=ww, blocks=k, tile=[th, tw], ms=ms))
                th, tw, _ = bs.plan_stack_tiles(1, c, 2 * c, hh, ww)
                picked = next(r for r in shape if r["tile"] == [th, tw])
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


# K2's calls: (graphs, features, side, window) of the 512x512 flagship
# request (2G graphs, full and half resolution per scale) and the pixel
# model's diamond-12 call
K2_CALLS = tuple((2 * g, f, 512 >> res, None) for s, (g, f) in
                 enumerate(((8, 6), (16, 6), (16, 12), (32, 12))) for res in (s, s + 1)) + (
    (48, 3, 512, DIAMOND12),)


def sweep_edges():
    """K2 in bf16 at K2_CALLS: the device time of every band that fits."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, summary = [], []
    for g, f, side, deltas in K2_CALLS:
        kw = {} if deltas is None else dict(deltas=deltas)
        radius = 1 if deltas is None else 2
        feats = torch.randn(1, g * f, side, side, device="cuda", generator=gen).bfloat16()
        m = (1 + 0.3 * torch.randn(g, f, device="cuda", generator=gen)).bfloat16()
        shape = []
        for bh in (1, 2, 4, 8, 16, 32, 64):
            for tx in (2, 4, 8):
                smem = ew.edge_smem_bytes(2, f, f, bh, tx, radius)
                if bh * tx > 256 or smem > ew.EDGE_SMEM:
                    continue
                with mock.patch.object(ew, "plan_edge_tiles", return_value=(bh, tx, f, smem)):
                    ms = device_ms(lambda: ew.edge_weights_chw(feats, m, n_graphs=g, **kw), 20)
                shape.append(dict(shape=[1, g * f, side, side], radius=radius, band=[bh, tx],
                                  device_ms=ms))
        bh, tx, _, _ = ew.plan_edge_tiles(f, 2, radius)
        picked = next(r for r in shape if r["band"] == [bh, tx])
        best = min(shape, key=lambda r: r["device_ms"])
        rows += shape
        summary.append(dict(k2=[1, g * f, side, side], fastest=best, picked=picked,
                            ratio=picked["device_ms"] / best["device_ms"]))
    return rows, summary


def _softmax_weights(gen, *shape):  # (B, G, E, h, w) softmax over the window
    return torch.softmax(torch.randn(*shape, device="cuda", generator=gen), dim=2)


def sweep_segments():
    """K8 in bf16, both tile plans, by device time, at (1, 512, 512, 72),
    G = 24 (the pixel model's 512x512 segment). Inputs U[0, 1), weights
    softmaxes of N(0, 1) draws, the per-channel scalars 0.1."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, summary = [], []

    def rnd(*shape):
        return torch.rand(*shape, device="cuda", generator=gen).bfloat16()

    g, c, n = 24, 72, 512
    x, aux, prev = (rnd(1, n, n, c) for _ in range(3))
    wg, wl = (_softmax_weights(gen, 1, n, n, 12, g).reshape(1, n, n, 12 * g).bfloat16()
              for _ in range(2))
    p = torch.tensor([[1.0, 0.5, 0.5, 0.5]] * 2, device="cuda")
    sc = torch.full((5, c), 0.1, device="cuda")
    for mode, a_, p_, wl_ in (("rhs", None, None, None), ("cg1", None, None, wl),
                              ("cg2", aux, prev, wl), ("rethresh", aux, None, None)):
        def run():
            return pn.pixel_segment_nhwc(x, a_, p_, wg, wl_, p, sc, mode=mode, n_graphs=g)
        shape = []
        for plan in range(len(pn.K8_PLANS)):
            with mock.patch.object(pn, "K8_PLAN", plan):
                shape.append(dict(k8=list(x.shape), mode=mode, plan=list(pn.K8_PLANS[plan][:3]),
                                  device_ms=device_ms(run, 10)))
        rows += shape
        best = min(shape, key=lambda r: r["device_ms"])
        picked = shape[pn.K8_PLAN]
        summary.append(dict(k8=list(x.shape), mode=mode, fastest=best, picked=picked,
                            ratio=picked["device_ms"] / best["device_ms"]))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.kernels.plan_sweep",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="write every timing to this JSON file")
    ap.add_argument("--segments-only", action="store_true", help="sweep K8 only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep needs a CUDA card")
    rows, summary = sweep_segments()
    if not args.segments_only:
        for part in (sweep(), sweep_edges()):
            rows += part[0]
            summary += part[1]
    for line in summary:
        print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
