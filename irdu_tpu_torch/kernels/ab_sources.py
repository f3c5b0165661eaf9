"""Time another checkout of the port against this tree on one card, in
turns: each turn runs one tree's ``chip_smoke.py`` whole, in a process of its
own, in the order base, tree, tree, base per round. Compared are every kernel
row that both trees time (their ``chiprun_out/chip_smoke_kernels.json``: K1
at the 512x512 request's four scales, K3, K4 at its three, K5, K6a, K6b and
the pixel and ablation kernels, bf16), the 512x512 request's latency (the
``blocks_512`` median of six requests with every block on its kernel), the
1024x1024 and 2048x2048 requests' (one each), the pixel model's NHWC and
CHW routes (``routes_*`` medians) and the ``band_route`` medians of the
scale-0 solve on K1 and on K5's band route.

    git archive <commit> irdu_tpu_torch chip_smoke.py | tar -x -C experiments/base
    ln -sfn "$PWD/artifacts" experiments/base/artifacts   # the weights
    python -m irdu_tpu_torch.kernels.ab_sources experiments/base [--rounds 2]

After each ``chip_smoke.py`` the turn runs DEVICE_PROBE in the same tree,
through that tree's own wrappers: the device time of K2 at every shape of
the 512x512 flagship request and at the pixel model's diamond-12 shape, of
K3 at the flagship's, of K5 in the 1024x1024 flagship request's five calls,
of K8 in its four modes at the 512x512 pixel request, of K7 at that request
(CHW route) and of the pixel solver's six-call K5 band route on the same
inputs, of K6a (GLR and the identity) and K6b (with y) on K5's scale-0
operands, and of K9
at the "single" ablation's 512x512 call (three a request), each from
torch.profiler (the kernels' own
durations over 20 calls, no host work: this tree's ``kernels/timing.py``),
so that a tree whose ``chip_smoke.py`` records no ``device_ms`` is compared
too. Rows that both trees' ``chip_smoke.py`` give a ``device_ms`` are
compared on it as well.

Before the turns it compiles each tree's copy of every source in
CODE_SOURCES with this tree's nvcc flags and compares what comes out per
entry function: ptxas's registers, stack and spills, and a digest of the
SASS (``cuobjdump -sass``), and whether each of the base's entry functions
has its SASS in the tree under any name. Its line goes first;
``--code-only`` stops there. ``--k1-probe`` runs K1_PROBE in the turns
instead of ``chip_smoke.py`` (K1 at the 512x512 request's four shapes and
the 512x512 request, a few minutes a round; ``chiprun_out/ab_k1_probe.json``).

Per compared row it prints one JSON line: the times of each turn of the
other checkout ("base") and of this tree ("tree"), their medians, minima and
maxima, and base / tree. The lines, and each tree's ``profile`` line where
its ``chip_smoke.py`` has one, also go to ``chiprun_out/ab_sources.json``,
with each turn's ``device_ms`` line (how its device times were taken).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from irdu_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# sources whose kernels' generated code is compared with the other
# checkout's: K1's cross-4 instances, K3's wgmma kernel, K5's cross-4 and
# diamond-12 instances and K8's diamond-12 ones
CODE_SOURCES = ("gg_unroll.cu", "block_stack_wgmma.cu", "fused_step_cross4.cu",
                "fused_step_hopper.cu", "pixel_nhwc.cu")
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
del args, blocks
# K5 at the 1024x1024 flagship request's five scale-0 calls (G = 8, F = 6,
# two-scale cross-4), and K8 in its four modes at the 512x512 pixel request
# (G = 24, F = 3); weights softmaxes over the window, as K2 gives them
from irdu_tpu_torch.ops.fused_step import fused_scal, gg_fused_step_chw
from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc
def unit(*shape):
    return torch.rand(*shape, device="cuda", generator=gen).bfloat16()
def soft(*shape, dim=2):
    return torch.softmax(rnd(*shape), dim=dim).bfloat16()
x, aux, prev = unit(1, 48, 1024, 1024), unit(1, 48, 1024, 1024), unit(1, 48, 1024, 1024)
ws = (soft(1, 8, 4, 1024, 1024), soft(1, 8, 4, 1024, 1024), soft(1, 8, 4, 512, 512),
      soft(1, 8, 4, 512, 512))
tab = torch.tensor([1.0, 0.5, 0.5, 0.5], device="cuda")[None, :, None].expand(8, 4, 6).contiguous()
v = torch.full((8,), 0.1, device="cuda")
scal = fused_scal(8, mu0=v, ro0=v, mu1=v, ro1=v, alpha=v, beta=v, gamma0=v, gamma1=v)
for name, mode, a_, p_, kw in (("rhs", "rhs", None, None, {}),
                               ("cg_use_x_rhs", "cg", None, None, dict(use_x_rhs=True)),
                               ("rethresh_y", "rethresh", aux, None, {}),
                               ("cg_emit_update", "cg", aux, None, dict(emit_update=True)),
                               ("cg_prev", "cg", aux, prev, {})):
    out[f"K5 [1, 48, 1024, 1024] {name}"] = device_ms(lambda: gg_fused_step_chw(
        x, a_, p_, *ws, tab, tab, tab, tab, scal, mode=mode, n_graphs=8, **kw))
# K6a (GLR and the identity) and K6b (with y) on the same scale-0 operands
from irdu_tpu_torch.ops.fused_step import gg_matvec_chw, gtv_rethresh_chw
out["K6a [1, 48, 1024, 1024] glr, identity"] = device_ms(lambda: gg_matvec_chw(
    x, ws[1], ws[0], tab, tab, v, v, n_graphs=8))
out["K6b [1, 48, 1024, 1024] y"] = device_ms(lambda: gtv_rethresh_chw(
    x, aux, ws[0], tab, v, v, n_graphs=8))
del x, aux, prev, ws
x, aux, prev = unit(1, 512, 512, 72), unit(1, 512, 512, 72), unit(1, 512, 512, 72)
wg, wl = (soft(1, 512, 512, 12, 24, dim=3).reshape(1, 512, 512, 288) for _ in range(2))
p = torch.tensor([[1.0, 0.5, 0.5, 0.5]] * 2, device="cuda")
sc = torch.full((5, 72), 0.1, device="cuda")
for mode, a_, p_, wl_ in (("rhs", None, None, None), ("cg1", None, None, wl),
                          ("cg2", aux, prev, wl), ("rethresh", aux, None, None)):
    out[f"K8 [1, 512, 512, 72] {mode}"] = device_ms(lambda: pixel_segment_nhwc(
        x, a_, p_, wg, wl_, p, sc, mode=mode, n_graphs=24))
del x, aux, prev, wg, wl
# K7 at the 512x512 pixel request (y (1, 3, 512, 512), G = 24, diamond-12)
# and its yardstick, the pixel solver's own six-call K5 band route
# (MixtureGTV._band_route, as chip_smoke.py's k7_yardstick times it) on the
# same inputs, both with a fresh MixtureGTV's solver parameters; K9 at the
# "single" ablation's (1, 512, 512, 96), G = 1, identity rows
from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw
from irdu_tpu_torch.ops.system_matvec import fused_system_matvec
from irdu_tpu_torch.solvers.pixel_gtv import MixtureGTV
mix = MixtureGTV(n_graphs=24).cuda()
y = unit(1, 3, 512, 512)
wg, wl = soft(1, 24, 12, 512, 512), soft(1, 24, 12, 512, 512)
with torch.no_grad():
    tables = (mix.GTVmodule00.stats_table(), mix.GLRmodule00.stats_table())
    k7s = mix._scal()
    out["K7 [1, 3, 512, 512] G=24"] = device_ms(lambda: gg_pixel_unroll_chw(
        y, wg, wl, *tables, k7s, n_graphs=24))
    out["K5 band route [1, 72, 512, 512] G=24, six calls"] = device_ms(
        lambda: mix._band_route(y.repeat(1, 24, 1, 1), wg, wl, tables))
del mix, y, wg, wl
x = unit(1, 512, 512, 96)
wgl, wgg = soft(1, 512, 512, 1, 4, dim=4), soft(1, 512, 512, 1, 4, dim=4)
rows = torch.zeros(4, 96, device="cuda")
rows[0] = 1.0
c96 = torch.full((96,), 0.3, device="cuda")
out["K9 [1, 512, 512, 96] G=1"] = device_ms(lambda: fused_system_matvec(
    x, wgl, wgg, rows, rows, c96, c96, n_graphs=1))
print(json.dumps(out))
"""


# run like DEVICE_PROBE: K1 at the 512x512 flagship request's four scale
# shapes (cross-4, the snapshot's tables, seeded planes and weights) by device
# time, and the 512x512 request itself (the 86k snapshot, bf16): host ms
# (median of 10 after 3 untimed) and device ms; prints {row: ms}
K1_PROBE = r"""
import importlib.util
import json
import sys
import time
import numpy as np
import torch
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
from irdu_tpu_torch.predict import denoise, load_model

spec = importlib.util.spec_from_file_location("timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
gen = torch.Generator(device="cuda").manual_seed(0)
out = {}
model = load_model(device="cuda")
with torch.inference_mode():
    for s, lf in enumerate(f.local_filter for f in model.local_filters):
        g, f, h = lf.n_graphs, lf.n_node_fts, 512 >> s
        y = torch.rand(1, g * f, h, h, device="cuda", generator=gen).bfloat16()
        ws = [torch.softmax(torch.randn(1, g, 4, h >> r, h >> r, device="cuda", generator=gen),
                            dim=2).bfloat16() for r in (0, 0, 1, 1)]
        tabs = [m.stats_table().float() for m in (lf.GTVmodule00, lf.GLRmodule00,
                                                  lf.GTVmodule01, lf.GLRmodule01)]
        scal = torch.rand(g, 10, device="cuda", generator=gen) * 0.3 + 0.1
        out[f"K1 {list(y.shape)}"] = timing.device_ms(
            lambda: gg_unroll_chw(y, *ws, *tabs, scal, n_graphs=g), 20)
out["K1 per 512x512 request"] = sum(v for k, v in out.items() if k.startswith("K1 ["))
noisy = np.random.RandomState(0).rand(512, 512, 3).astype(np.float32)
for _ in range(3):
    denoise(model, noisy)
ms = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    denoise(model, noisy)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
out["request 512x512 host ms"] = float(np.median(ms))
out["request 512x512 device ms"] = timing.device_ms(lambda: denoise(model, noisy), 5)
print(json.dumps(out))
"""


def _k1_turn(tree: str) -> dict:
    """K1_PROBE in ``tree``: its rows. Raises if it fails."""
    probe = subprocess.run([sys.executable, "-c", K1_PROBE,
                            os.path.join(REPO, "irdu_tpu_torch", "kernels", "timing.py")],
                           cwd=tree, capture_output=True, text=True)
    if probe.returncode != 0:
        raise RuntimeError(f"the K1 probe in {tree} failed ({probe.returncode}):\n"
                           f"{probe.stderr[-3000:]}")
    return json.loads(probe.stdout.strip().splitlines()[-1])


def sass_digests(sass: str) -> dict:
    """{entry function: sha256 of its SASS lines} from ``cuobjdump -sass``."""
    out, name, lines = {}, None, []
    for line in sass.splitlines() + ["Function : "]:
        if "Function : " in line:
            if name:
                out[name] = hashlib.sha256("\n".join(lines).encode()).hexdigest()
            name, lines = line.split("Function : ", 1)[1].strip(), []
        elif name:
            lines.append(line.strip())
    return out


def compiled_code(tree: str, source: str) -> dict:
    """``source`` under ``tree``'s kernels/csrc compiled alone with this
    tree's flags: per entry function its ptxas report and SASS digest (None
    without cuobjdump)."""
    src = os.path.join(tree, "irdu_tpu_torch", "kernels", "csrc", source)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    obj = os.path.join(build.BUILD_DIR, f"code.{os.getpid()}.{abs(hash((tree, source)))}.o")
    try:
        log = build._nvcc([build.nvcc_path(), *build.NVCC_FLAGS, "-c", src, "-o", obj])
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        sass = (subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                               check=True).stdout if os.path.isfile(cuobjdump) else None)
    finally:
        if os.path.exists(obj):
            os.remove(obj)
    digests = sass_digests(sass) if sass is not None else {}
    return {r["name"]: dict(r, sass=digests.get(r["name"])) for r in build.ptxas_report(log, "")}


def compare_code(base: str) -> dict:
    """CODE_SOURCES' generated code in ``base`` and in this tree (each
    source of each tree compiled by its own nvcc, all at once): each entry
    function's report in both, whether they are equal (``same``: names,
    registers, stack, spills and SASS digest), and which of the base's entry
    functions have their SASS in the tree under any name (``base_kept``: an
    instance renamed by a new template argument keeps its code; ``missing``:
    the base's entries whose code the tree has not)."""
    jobs = [(tree, source) for source in CODE_SOURCES for tree in (base, REPO)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda job: compiled_code(*job), jobs)))
    out = {}
    for source in CODE_SOURCES:
        a, b = done[(base, source)], done[(REPO, source)]
        tree_sass = {r["sass"] for r in b.values() if r["sass"]}
        missing = [name for name, r in a.items() if r["sass"] not in tree_sass]
        out[source] = dict(same=a == b, base_kept=not missing, missing=missing, base=a, tree=b)
    return out


def _turn(tree: str) -> tuple[dict, dict | None, dict | None]:
    """Run ``tree``'s chip_smoke.py once: its timed rows by name, its
    profile line and its ``device_ms`` line (None where it has none). Raises
    if the run fails."""
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
    device = json.loads(probe.stdout.strip().splitlines()[-1])
    timed.update({f"device {k}": v for k, v in device.items()})
    k5 = [v for k, v in device.items() if k.startswith("K5 [1, 48, 1024, 1024] ")]
    if k5:  # the five calls of one 1024x1024 flagship request
        timed["device K5 per 1024x1024 request"] = sum(k5)
    k8 = {k.split()[-1]: v for k, v in device.items() if k.startswith("K8 ")}
    if k8:  # rhs, cg1, cg2, rethresh, cg1, cg2
        timed["device K8 per 512x512 pixel request"] = sum(
            v * (2 if mode in ("cg1", "cg2") else 1) for mode, v in k8.items())
    for key, calls, name in (("K7 ", 1, "device K7 per 512x512 pixel request"),
                             ("K5 band route ", 1, "device K5 band route per 512x512 pixel request"),
                             ("K9 ", 3, "device K9 per 512x512 single request")):
        hit = [v for k, v in device.items() if k.startswith(key)]
        if hit:
            timed[name] = calls * hit[0]
    timed["request 512x512"] = lines["serving"]["blocks_512"]["median_kernels_ms"]
    for row in lines["serving"]["serving"]:
        if row["shape"][0] >= 1024:  # one request each, no warm-up of its own
            timed[f"request {row['shape'][0]}x{row['shape'][1]}"] = row["ms"]
    for key, route in lines["pixel"].items():
        if key.startswith("routes_"):
            side = route["shape"][0]
            timed[f"pixel NHWC {side}x{side}"] = route["median_nhwc_ms"]
            timed[f"pixel CHW {side}x{side}"] = route["median_chw_ms"]
    timed["scale-0 solve on K1"] = lines["band_route"]["median_k1_ms"]
    timed["scale-0 solve on the band route"] = lines["band_route"]["median_band_ms"]
    return timed, lines.get("profile"), lines.get("device_ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.kernels.ab_sources",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("base", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--code-only", action="store_true",
                    help="compare the generated code of CODE_SOURCES only")
    ap.add_argument("--k1-probe", action="store_true",
                    help="after the code, run K1_PROBE in turns instead of chip_smoke.py")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    code = compare_code(os.path.abspath(args.base))
    print(json.dumps({"code": code}), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    if args.code_only:
        with open(os.path.join(REPO, "chiprun_out", "ab_code.json"), "w") as fh:
            json.dump({"device": smi.stdout.strip(), "code": code}, fh, indent=1)
        return
    trees = {"base": os.path.abspath(args.base), "tree": REPO}
    turns = {"base": [], "tree": []}
    profiles, sessions = {}, []
    for _ in range(args.rounds):
        for which in ("base", "tree", "tree", "base"):
            if args.k1_probe:
                timed, how = _k1_turn(trees[which]), None
            else:
                timed, profiles[which], how = _turn(trees[which])
            turns[which].append(timed)
            sessions.append(dict(tree=which, device_ms=how))
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
    name = "ab_k1_probe.json" if args.k1_probe else "ab_sources.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as fh:
        json.dump({"device": smi.stdout.strip(), "order": "base, tree, tree, base per round",
                   "rounds": args.rounds, "code": code, "rows": rows, "profiles": profiles,
                   "device_ms_by_turn": sessions}, fh, indent=1)


if __name__ == "__main__":
    main()
