"""PSNR against throughput for one snapshot's inference variants
(counterpart: the eval part of ``scripts/psnr_vs_throughput.py``).

    python -m irdu_tpu_torch.eval.curve --model flagship
    python -m irdu_tpu_torch.eval.curve --model lite --filter-scales 1,2,3
    python -m irdu_tpu_torch.eval.curve --model pixel
    python -m irdu_tpu_torch.eval.curve --model drunet       # restormer, swinir, dncnn

Variants: the full unroll (cg3) and a one-step one (cg1), and with
``--filter-scales`` both again filtering only those scales (cg3-fs, cg1-fs);
the pixel model, GLR boosting and the baselines (``predict.BASELINES``;
SwinIR has no snapshot: pass ``--weights``) have one. Each is evaluated by
the reference protocol (``harness.evaluate_pairs``, bucket 64, seed-2204
noise) on the synthetic val set (``data.synthetic.synthetic_val_set``: 6
images at 384×512, made in memory, no PNG read) with the model
``predict.load_model`` gives (bf16 on the card). Throughput is the card's own: the median over ``REQUESTS``
timed 512×512 ``predict.denoise`` requests after warm-up, host clock,
synchronized on both sides.

Prints the card's name and power limit first (nvidia-smi), then one JSON
row a variant, {"variant", "psnr", "mp_per_s"}, then the list with
"psnr_delta_vs_full" (against the first variant).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from irdu_tpu_torch.data.synthetic import synthetic_val_set
from irdu_tpu_torch.eval.harness import evaluate_pairs
from irdu_tpu_torch.predict import BASELINES, FAMILY, batch_forward, denoise, load_model

REQUESTS = 10  # timed 512x512 requests a variant
WARMUP = 3
SIDE = 512
ONE_VARIANT = ("pixel", "boosting", *BASELINES)  # no unroll knobs: the model as built


def variants(name: str, filter_scales=None) -> list[tuple[int, tuple[int, ...] | None]]:
    """(cg_iters, filter_scales) per variant; one for a model without the
    flagship's unroll knobs."""
    if name in ONE_VARIANT:
        return [(3, None)]
    out = [(3, None), (1, None)]
    if filter_scales is not None:
        out += [(3, tuple(filter_scales)), (1, tuple(filter_scales))]
    return out


def variant_tag(name: str, cg: int, filter_scales) -> str:
    tag = name if name in ONE_VARIANT else f"{name}-cg{cg}"
    return tag + ("" if filter_scales is None else "-fs" + "".join(map(str, filter_scales)))


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return "nvidia-smi: n/a"
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"


def request_ms(model, reps: int = REQUESTS, warmup: int = WARMUP) -> list[float]:
    """Host-clock times (ms) of ``reps`` 512x512 ``predict.denoise`` requests
    after ``warmup`` untimed ones, synchronized on both sides."""
    x = np.random.RandomState(0).rand(SIDE, SIDE, 3).astype(np.float32)
    cuda = next(model.parameters()).is_cuda
    out = []
    for i in range(warmup + reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise(model, x)
        if cuda:
            torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def run(name: str = "flagship", weights: str | None = None, sigma: float = 25.0,
        filter_scales=None, device: str = "cuda", images=None,
        reps: int = REQUESTS) -> list[dict]:
    """One row a variant: protocol PSNR, MP/s at 512x512 (None with no
    timed request), and the gap to the first variant."""
    images = synthetic_val_set() if images is None else images
    rows = []
    for cg, fs in variants(name, filter_scales):
        model = load_model(weights, device, name=name, cg_iters=cg, filter_scales=fs)
        res = evaluate_pairs(batch_forward(model), images, sigma=sigma, bucket=64)
        ms = float(np.median(request_ms(model, reps))) if reps else None
        rows.append({"variant": variant_tag(name, cg, fs), "psnr": res["mean_psnr"],
                     "mp_per_s": SIDE * SIDE / ms / 1e3 if ms else None})
        del model
    for r in rows:
        r["psnr_delta_vs_full"] = r["psnr"] - rows[0]["psnr"]
    return rows


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.eval.curve",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="flagship", choices=(*FAMILY, *BASELINES))
    ap.add_argument("--weights", default=None,
                    help="npz snapshot (default: predict.DEFAULT_WEIGHTS[model])")
    ap.add_argument("--sigma", type=float, default=25.0,
                    help="eval noise level (the snapshot's training sigma)")
    ap.add_argument("--filter-scales", default=None,
                    help="comma list of scales to keep filtering (e.g. 1,2,3): adds "
                         "the -fs variants")
    args = ap.parse_args(argv)
    fs = None if args.filter_scales is None else [int(s) for s in args.filter_scales.split(",")]
    if args.model in ONE_VARIANT and fs is not None:
        ap.error(f"--filter-scales does not apply to the {args.model} model")
    print(card(), flush=True)
    rows = run(args.model, args.weights, args.sigma, fs, device)
    for r in rows:
        print(json.dumps({k: v for k, v in r.items() if k != "psnr_delta_vs_full"}), flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
