"""Time another checkout of the port against this tree on one card, in
turns: each turn runs one tree's ``chip_smoke.py`` whole, in a process of its
own, in the order base, tree, tree, base per round. Compared are every kernel
row that both trees time (their ``chiprun_out/chip_smoke_kernels.json``: K1
at the 512x512 request's four scales, K3, K4 at its three, K5, K6a, K6b and
the pixel and ablation kernels, bf16), the 512x512 request's latency (the
``blocks_512`` median of six requests with every block on its kernel) and
the ``band_route`` medians of the scale-0 solve on K1 and on K5's band route.

    git archive <commit> irdu_tpu_torch chip_smoke.py | tar -x -C experiments/base
    ln -sfn "$PWD/artifacts" experiments/base/artifacts   # the weights
    python -m irdu_tpu_torch.kernels.ab_sources experiments/base [--rounds 2]

After each ``chip_smoke.py`` the turn runs DEVICE_PROBE in the same tree,
through that tree's own wrappers: the device time of K2 at every shape of
the 512x512 flagship request and at the pixel model's diamond-12 shape, and
of K3 at the flagship's, each from torch.profiler (the kernels' own
durations over 20 calls, no host work: this tree's ``kernels/timing.py``),
so that a tree whose ``chip_smoke.py`` records no ``device_ms`` is compared
too. Rows that both trees' ``chip_smoke.py`` give a ``device_ms`` are
compared on it as well.

Per compared row it prints one JSON line: the times of each turn of the
other checkout ("base") and of this tree ("tree"), their medians, minima and
maxima, and base / tree. The lines, and each tree's ``profile`` line where
its ``chip_smoke.py`` has one, also go to ``chiprun_out/ab_sources.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# what tells two kernel rows of chip_smoke_kernels.json apart, besides the kernel
ROW_KEYS = ("scale", "request", "case", "mode", "blocks", "n_graphs", "shape", "dtype")
# run with python -c in a tree's root, so that it imports that tree's package;
# prints {row: device ms per call}
DEVICE_PROBE = r"""
import importlib.util
import json
import sys
import torch
from irdu_tpu_torch.ops.block_stack import fused_block_stack, pack_block_params
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.windows import DIAMOND12

# this tree's kernels/timing.py, loaded by path (the other tree may lack it)
spec = importlib.util.spec_from_file_location("timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
def device_ms(fn):
    return timing.device_ms(fn, 20)

gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(*shape, device="cuda", generator=gen)
out = {}
# K2 at the 512x512 flagship request's shapes (2G graphs, F = C / G per
# scale, full and half resolution), multi_m in bf16 as the model serves it
for s, (g, f) in enumerate(((8, 6), (16, 6), (16, 12), (32, 12))):
    for res in (s, s + 1):
        feats = rnd(1, 2 * g * f, 512 >> res, 512 >> res).bfloat16()
        m = (1 + 0.3 * rnd(2 * g, f)).bfloat16()
        out[f"K2 {list(feats.shape)}"] = device_ms(lambda: edge_weights_chw(feats, m, n_graphs=2 * g))
feats = rnd(1, 144, 512, 512).bfloat16()
m = (1 + 0.3 * rnd(48, 3)).bfloat16()
out["K2 diamond-12 [1, 144, 512, 512]"] = device_ms(
    lambda: edge_weights_chw(feats, m, n_graphs=48, deltas=DIAMOND12))
blocks = [dict(scale=rnd(48) * 0.1 + 1, w1=rnd(48, 192) / 48 ** 0.5, dwk=rnd(3, 3, 192) * 0.2,
               w2=rnd(96, 48) / 96 ** 0.5, skip=torch.tensor([1.0, 0.8], device="cuda"))
          for _ in range(4)]
args = (rnd(1, 48, 512, 512).bfloat16(), *pack_block_params(blocks, torch.bfloat16))
out["K3 [1, 48, 512, 512] x4"] = device_ms(lambda: fused_block_stack(*args))
print(json.dumps(out))
"""


def _turn(tree: str) -> tuple[dict, dict | None]:
    """Run ``tree``'s chip_smoke.py once: its timed rows by name, and its
    profile line (None if it has none). Raises if the run fails."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    out = os.path.join(tree, "chiprun_out")
    with open(os.path.join(out, "chip_smoke_kernels.json")) as fh:
        kernels = json.load(fh)
    with open(os.path.join(out, "chip_smoke_lines.json")) as fh:
        lines = json.load(fh)
    timed = {json.dumps([name] + [r.get(k) for k in ROW_KEYS]): r["ms"]
             for name, rows in kernels.items() for r in rows if r.get("ms") is not None}
    timed.update({json.dumps([name, "device_ms"] + [r.get(k) for k in ROW_KEYS]): r["device_ms"]
                  for name, rows in kernels.items() for r in rows
                  if r.get("device_ms") is not None})
    probe = subprocess.run([sys.executable, "-c", DEVICE_PROBE,
                            os.path.join(REPO, "irdu_tpu_torch", "kernels", "timing.py")],
                           cwd=tree, capture_output=True, text=True)
    if probe.returncode != 0:
        raise RuntimeError(f"the device probe in {tree} failed ({probe.returncode}):\n"
                           f"{probe.stderr[-3000:]}")
    timed.update({f"device {k}": v for k, v in
                  json.loads(probe.stdout.strip().splitlines()[-1]).items()})
    timed["request 512x512"] = lines["serving"]["blocks_512"]["median_kernels_ms"]
    timed["scale-0 solve on K1"] = lines["band_route"]["median_k1_ms"]
    timed["scale-0 solve on the band route"] = lines["band_route"]["median_band_ms"]
    return timed, lines.get("profile")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.kernels.ab_sources",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("base", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    trees = {"base": os.path.abspath(args.base), "tree": REPO}
    turns = {"base": [], "tree": []}
    profiles = {}
    for _ in range(args.rounds):
        for which in ("base", "tree", "tree", "base"):
            timed, profiles[which] = _turn(trees[which])
            turns[which].append(timed)
    rows = []
    for name in turns["tree"][0]:
        if not all(name in t for side in turns.values() for t in side):
            continue  # timed by one tree only
        row = {"row": name}
        for which in ("base", "tree"):
            per_turn = [t[name] for t in turns[which]]
            row[which] = dict(median_ms=float(np.median(per_turn)), min_ms=min(per_turn),
                              max_ms=max(per_turn), turns_ms=per_turn)
        row["base_over_tree"] = row["base"]["median_ms"] / row["tree"]["median_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab_sources.json"), "w") as fh:
        json.dump({"device": smi.stdout.strip(), "order": "base, tree, tree, base per round",
                   "rounds": args.rounds, "rows": rows, "profiles": profiles}, fh, indent=1)


if __name__ == "__main__":
    main()
