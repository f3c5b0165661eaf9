"""The natural-image eval (counterpart: ``scripts/eval_natural_benchmark.py``):
the committed snapshots on ``artifacts/natural_eval/``, four RGB photographs
(66×484, 124×143, 157×483, 470×235) with suspect-pixel masks, by the
reference protocol (seed-2204 noise at ``--sigma``, reflect pad to bucket 64,
uint8 PSNR), each mean beside its masked mean (the suspect pixels left out).

    python -m irdu_tpu_torch.eval.natural                    # every served snapshot present
    python -m irdu_tpu_torch.eval.natural --sigma 15 --model flagship \
        --weights artifacts/weights/flagship_synthetic_s15_2050.npz
    python -m irdu_tpu_torch.eval.natural --out rows.jsonl   # also write the rows

Runs on the CUDA card in bf16 through the kernels (``predict.load_model``);
``main(device="cpu")`` runs f32 on the CPU through their plain versions. The
PNGs are read by ``data/png.py`` (no PIL). Prints the noisy input's row,
one JSON row a snapshot with the keys of the JAX package's
``results_sigma*.jsonl``, then {"sigma", "noisy", "results"}. Nothing is
written unless ``--out`` names a file (the full sweep writes the noisy row
first, a single ``--weights`` run appends its row, as JAX's script does).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from irdu_tpu_torch.eval.harness import evaluate_pairs, load_benchmark_images, load_masks

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(_REPO, "artifacts", "natural_eval")
WEIGHTS = os.path.join(_REPO, "artifacts", "weights")
BUCKET = 64
# JAX's list, in its order (scripts/eval_natural_benchmark.py); a snapshot
# that is not in the tree (swinir_synthetic_2050.npz) is skipped, as there
SNAPSHOTS = [
    ("flagship", "flagship_synthetic_2050.npz"),
    ("flagship", "flagship_ext_6050.npz"),
    ("flagship", "flagship_50k_51000.npz"),
    ("flagship", "flagship_natural_ft.npz"),
    ("lite", "lite_synthetic_2050.npz"),
    ("micro", "micro_synthetic_2050.npz"),
    ("micro", "micro_distill03_2050.npz"),
    ("pixel", "pixel_synthetic_2050.npz"),
    ("boosting", "boosting_synthetic_2050.npz"),
    ("drunet", "drunet_synthetic_2050.npz"),
    ("dncnn", "dncnn_synthetic_2050.npz"),
    ("restormer", "restormer_synthetic_2050.npz"),
    ("swinir", "swinir_synthetic_2050.npz"),
    ("flagship", "flagship_cont100k_35000.npz"),
]


def load_set(data: str = DATA) -> tuple[list[np.ndarray], list[np.ndarray | None] | None]:
    """The set's images and, where ``<data>/masks`` exists, their masks."""
    index = os.path.join(data, "index.csv")
    images = load_benchmark_images(index, os.path.join(data, "images"))
    mask_dir = os.path.join(data, "masks")
    return images, load_masks(index, mask_dir) if os.path.isdir(mask_dir) else None


def noisy_row(images, masks, sigma: float, bucket: int = BUCKET) -> dict:
    """The noisy input scored as the restored image (the identity forward)."""
    res = evaluate_pairs(lambda x: x, images, sigma, bucket=bucket, masks=masks)
    return {"snapshot": "noisy-input", "psnr": res["mean_psnr"],
            "masked_psnr": res.get("mean_masked_psnr")}


def snapshot_row(name: str, weights: str, images, masks, sigma: float, *,
                 device="cuda", dtype: torch.dtype | None = None,
                 bucket: int = BUCKET) -> dict:
    """One snapshot's row: the model ``predict.load_model`` builds (bf16 on
    the card, f32 on the CPU unless ``dtype``) through the protocol."""
    from irdu_tpu_torch.predict import batch_forward, load_model

    model = load_model(weights, device, dtype, name=name)
    res = evaluate_pairs(batch_forward(model), images, sigma, bucket=bucket, masks=masks)
    return {"snapshot": os.path.basename(weights), "model": name, "psnr": res["mean_psnr"],
            "psnr_std": float(np.std(res["psnr"])), "masked_psnr": res.get("mean_masked_psnr"),
            "per_image": [round(p, 3) for p in res["psnr"]]}


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.eval.natural",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=DATA)
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--bucket", type=int, default=BUCKET)
    ap.add_argument("--model", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default=None, help="jsonl to write the rows to (default: none)")
    args = ap.parse_args(argv)

    images, masks = load_set(args.data)
    noisy = noisy_row(images, masks, args.sigma, args.bucket)
    print(json.dumps(noisy), flush=True)
    if args.weights:
        todo = [(args.model or "flagship", args.weights)]
    else:
        todo = [(name, os.path.join(WEIGHTS, f)) for name, f in SNAPSHOTS
                if args.model in (None, name) and os.path.exists(os.path.join(WEIGHTS, f))]
    results = []
    for name, path in todo:
        results.append(snapshot_row(name, path, images, masks, args.sigma, device=device,
                                    bucket=args.bucket))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"sigma": args.sigma, "noisy": noisy["psnr"], "results": results}))
    if args.out:
        with open(args.out, "a" if args.weights else "w") as fh:
            for row in ([] if args.weights else [noisy]) + results:
                fh.write(json.dumps(row) + "\n")
        print(f"wrote {len(results)} row(s) -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
