"""Time the block kernel of another checkout's kernel sources against this
tree's, on one card, in turns: K3 at the 512² request's scale 0 and K4 at
scales 1-3, with the 86k snapshot's blocks in bf16 (the shapes and timing of
``chip_smoke.py``'s kernel rows). Both libraries must export the same
``irdu_block_stack`` entry point; the launch plan is this tree's.

    git archive <commit> irdu_tpu_torch/kernels/csrc | tar -x -C experiments/base
    python -m irdu_tpu_torch.kernels.ab_sources experiments/base/irdu_tpu_torch/kernels/csrc

Per shape it prints one JSON line: the times of the other sources ("base")
and of this tree ("tree") in the order base, tree, tree, base per round, and
whether both outputs are equal; all lines also go to
``chiprun_out/ab_sources.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from irdu_tpu_torch.kernels import build
from irdu_tpu_torch.ops import block_stack, gated_block
from irdu_tpu_torch.predict import load_model


def _library_of(csrc: str) -> ctypes.CDLL:
    """Build the sources in ``csrc`` into their own directory and load them."""
    here = (build.CSRC_DIR, build.BUILD_DIR)
    build.CSRC_DIR, build.BUILD_DIR = csrc, os.path.join(os.path.dirname(csrc), "_build")
    try:
        lib = ctypes.CDLL(build.build()[0])
    finally:
        build.CSRC_DIR, build.BUILD_DIR = here
    fn = lib.irdu_block_stack
    fn.argtypes, fn.restype = build._SIGNATURES["irdu_block_stack"]
    return lib


def _ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.kernels.ab_sources",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("csrc", help="the other checkout's irdu_tpu_torch/kernels/csrc")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = {"tree": build.kernel_library(), "base": _library_of(os.path.abspath(args.csrc))}
    model = load_model(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for s in range(4):
            blocks = model.encoder_scales[s][:4] if s == 0 else model.encoder_scales[s][:1]
            x = torch.randn(1, model.dims[s], 512 >> s, 512 >> s, device="cuda",
                            generator=gen).to(torch.bfloat16)
            if s == 0:
                ops = block_stack.pack_block_params([b.gated_params() for b in blocks],
                                                    torch.bfloat16)
                call = lambda: block_stack.fused_block_stack(x, *ops)  # noqa: E731
            else:
                params = blocks[0].gated_params()
                call = lambda: gated_block.fused_gated_block(x, **params)  # noqa: E731
            times, outs = {"base": [], "tree": []}, {}
            for _ in range(args.rounds):
                for which in ("base", "tree", "tree", "base"):
                    gated_block.kernel_library = lambda lib=libs[which]: lib
                    times[which].append(round(_ms(call), 5))
                    outs[which] = call()
            torch.cuda.synchronize()
            row = dict(kernel="fused_block_stack" if s == 0 else "fused_gated_block",
                       shape=list(x.shape), **times,
                       equal=bool(torch.equal(outs["base"], outs["tree"])))
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        gated_block.kernel_library = build.kernel_library
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ab_sources.json"), "w") as fh:
        json.dump({"device": smi.stdout.strip(), "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
