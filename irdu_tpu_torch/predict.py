"""Single-command denoising on the GPU (counterpart: ``irdu_tpu/predict.py``).

    # denoise an already-noisy image
    python -m irdu_tpu_torch.predict --input noisy.png --output out.png

    # protocol mode: synthesize seed-2204 σ=25 noise from a clean image,
    # denoise, report uint8-domain PSNR (the benchmark convention)
    python -m irdu_tpu_torch.predict --input clean.png --sigma 25 --output out.png

    # the pixel-domain family (MultiScaleSequenceDenoiser)
    python -m irdu_tpu_torch.predict --model pixel --input clean.png --sigma 25 --output out.png

    # a large image as overlapping 512x512 tiles (64-pixel halo)
    python -m irdu_tpu_torch.predict --input big.png --sigma 25 --tile 512 --output out.png

The model runs on the CUDA card in bf16 (params and activations) through the
port's kernels (flagship, lite, micro: K3 and K4 for the encoder/decoder
blocks, K1, K2 and K5 for the solver; pixel: K2 and K8, or K2 and K7 on
its CHW route); ``load_model(..., device="cpu")`` runs it in f32 on the CPU through
the kernels' plain versions. JAX's CLI serves the pixel family on its jnp
path; the port serves it through its kernels, with the same arithmetic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from irdu_tpu_torch.data.png import read_rgb, write_png
from irdu_tpu_torch.models.flagship import (
    AbstractMultiScaleGraphFilter,
    flagship_config,
    flagship_lite_config,
    flagship_micro_config,
)
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.utils.weights import load_params_npz, params_to_torch

_CONFIGS = {"flagship": flagship_config, "lite": flagship_lite_config,
            "micro": flagship_micro_config}
FAMILY = (*_CONFIGS, "pixel")  # the CLI's choices, JAX's
# the baselines as JAX's eval scripts build them (scripts/eval_natural_benchmark.py
# and scripts/psnr_vs_throughput.py: the same constructions): registry name, fields
BASELINES = {
    "restormer": ("restormer", {"norm_type": "BiasFree"}),
    "drunet": ("drunet", {"in_nc": 3, "out_nc": 3}),
    "dncnn": ("dncnn", {"in_nc": 3, "out_nc": 3, "nc": 64, "nb": 17, "act_mode": "R"}),
    "swinir": ("swinir", {}),
}
# every family ``build_model`` and ``load_model`` take: GLR boosting (its
# default build) and the baselines besides the CLI's
FAMILIES = (*FAMILY, "boosting", *BASELINES)
_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "artifacts", "weights")
# The 86k-step flagship snapshot (σ=25), pinned: the newest-by-name file in
# the directory is a σ=50 snapshot. lite, micro and pixel take the file JAX's
# default_weights picks, the last of the name by sort order.
# GLR boosting and the baselines take their one snapshot (SwinIR has none).
DEFAULT_WEIGHTS = {name: os.path.join(_WEIGHTS_DIR, fname) for name, fname in (
    ("flagship", "flagship_cont100k_35000.npz"), ("lite", "lite_synthetic_2050.npz"),
    ("micro", "micro_synthetic_2050.npz"), ("pixel", "pixel_synthetic_2050.npz"),
    ("boosting", "boosting_synthetic_2050.npz"), ("drunet", "drunet_synthetic_2050.npz"),
    ("dncnn", "dncnn_synthetic_2050.npz"), ("restormer", "restormer_synthetic_2050.npz"))}


def build_model(name: str = "flagship", *, cg_iters: int = 3, filter_scales=None):
    """One member of the family, randomly initialized. filter_scales: filter
    only these scales' codes (None: all four). The pixel model (24 graphs × 3
    node features, 72-wide feature U-Net, diamond-12) takes neither knob and
    runs its unroll on the kernel routes (NHWC first, then CHW); nor do GLR
    boosting (its default build: 4 levels, 5 graphs, ring-8, 5 CG steps) and
    the baselines (``BASELINES``)."""
    if name not in FAMILIES:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(FAMILIES)}")
    if name not in _CONFIGS and (filter_scales is not None or cg_iters != 3):
        raise ValueError(f"--filter-scales/--cg-iters do not apply to the {name} "
                         "model (its unroll, if any, is fixed); remove them")
    if name == "pixel":
        return MultiScaleSequenceDenoiser(n_graphs=24, n_node_fts=3, n_cnn_fts=72,
                                          use_pallas_solver=True, use_nhwc_solver=True)
    if name == "boosting":
        from irdu_tpu_torch.models.glr_boosting import GLRBoostingPyramid

        return GLRBoostingPyramid()
    if name in BASELINES:
        from irdu_tpu_torch.models.registry import create_model

        kind, kw = BASELINES[name]
        return create_model(kind, **kw)
    return AbstractMultiScaleGraphFilter(eval_cg_iters=cg_iters,
                                         eval_filter_scales=filter_scales,
                                         **_CONFIGS[name]())


def load_model(weights: str | None = None, device: str | torch.device = "cuda",
               dtype: torch.dtype | None = None, *, name: str = "flagship",
               cg_iters: int = 3, filter_scales=None):
    """Build the model, load an npz snapshot onto it and move it to ``device``
    in ``dtype`` (default: bf16 on CUDA, f32 on the CPU), in eval mode."""
    weights = weights or DEFAULT_WEIGHTS.get(name)
    if weights is None:
        raise ValueError(f"no default snapshot for {name!r}: pass weights")
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_model(name, cg_iters=cg_iters, filter_scales=filter_scales)
    params_to_torch(load_params_npz(weights), model)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def batch_forward(model: torch.nn.Module):
    """The model as the eval harness and the tilers call it: a float32 batch
    (B, H, W, 3), numpy or a tensor, H and W multiples of 16, to the float32
    output tensor on the model's device."""
    p = next(model.parameters())

    def forward(batch) -> torch.Tensor:
        x = (batch if isinstance(batch, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(batch, np.float32)))
        with torch.inference_mode():
            return model(x.to(device=p.device, dtype=p.dtype)).float()

    return forward


def denoise(model: torch.nn.Module, noisy_hwc: np.ndarray, *, tile: int = 0) -> np.ndarray:
    """Denoise one (H, W, 3) float image in [0, 1]: numpy reflect pad to a
    multiple of 16, forward, crop, clamp to [0, 1]. Returns float32 (H, W, 3).
    tile > 0: run overlapping tile × tile tiles with a 64-pixel halo
    (``parallel.spatial.tiled_forward``), for images too large for one pass."""
    noisy_hwc = np.asarray(noisy_hwc, np.float32)
    if tile:
        from irdu_tpu_torch.parallel.spatial import tiled_forward

        return np.clip(tiled_forward(batch_forward(model), noisy_hwc, tile=tile, halo=64),
                       0.0, 1.0)
    h, w = noisy_hwc.shape[:2]
    pad = np.pad(noisy_hwc, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="reflect")
    y = batch_forward(model)(pad[None])[0, :h, :w].cpu().numpy()
    return np.clip(y, 0.0, 1.0)


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise SystemExit(f"{path}: only PNG is read and written without PIL, "
                         "which is not installed") from exc
    return Image


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8, as PIL's ``convert("RGB")`` gives
    it: a PNG through ``data/png.py``, another format through PIL."""
    if path.lower().endswith(".png"):
        return read_rgb(path)
    return np.asarray(_pil(path).open(path).convert("RGB"))


def write_image(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8: PNG through ``data/png.py``, another format
    through PIL."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        _pil(path).fromarray(img).save(path)


def main(argv=None, device: str = "cuda"):
    from irdu_tpu_torch.eval.metrics import img_as_ubyte, psnr_255

    ap = argparse.ArgumentParser(
        prog="python -m irdu_tpu_torch.predict", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, help="input PNG (other formats need PIL)")
    ap.add_argument("--output", required=True, help="denoised PNG path")
    ap.add_argument("--model", default="flagship", choices=FAMILY)
    ap.add_argument("--weights", default=None,
                    help="npz snapshot (default: artifacts/weights/"
                         "flagship_cont100k_35000.npz, lite_synthetic_2050.npz, "
                         "micro_synthetic_2050.npz, pixel_synthetic_2050.npz)")
    ap.add_argument("--sigma", type=float, default=None,
                    help="treat --input as CLEAN: add N(0, σ/255) noise "
                         "(benchmark protocol) and report PSNR")
    ap.add_argument("--seed", type=int, default=2204,
                    help="noise seed for --sigma mode (protocol: 2204)")
    ap.add_argument("--clean", default=None,
                    help="clean reference image for PSNR reporting when "
                         "--input is already noisy")
    ap.add_argument("--cg-iters", type=int, default=3,
                    help="solver unroll length (3 = exact reference semantics)")
    ap.add_argument("--tile", type=int, default=0,
                    help=">0: overlapping-tile inference (tile size in pixels, "
                         "64-pixel halo) for images too large for one pass")
    args = ap.parse_args(argv)

    try:
        model = load_model(args.weights, device, name=args.model,
                           cg_iters=args.cg_iters)
    except ValueError as exc:
        sys.exit(str(exc))

    clean_255 = None
    img = read_image(args.input).astype(np.float32)
    if args.sigma is not None:
        clean_255 = img
        rs = np.random.RandomState(args.seed)
        noisy = img / 255.0 + rs.normal(0, args.sigma / 255.0, img.shape)
    else:
        noisy = img / 255.0
        if args.clean:
            clean_255 = read_image(args.clean).astype(np.float32)
    noisy = noisy.astype(np.float32)

    denoise(model, noisy, tile=args.tile)  # warm-up (kernel build, allocator)
    t0 = time.perf_counter()
    restored = denoise(model, noisy, tile=args.tile)
    dt = time.perf_counter() - t0

    out_u8 = img_as_ubyte(restored)
    write_image(args.output, out_u8)
    report = {
        "model": args.model,
        "weights": os.path.basename(args.weights or DEFAULT_WEIGHTS[args.model]),
        "device": str(next(model.parameters()).device),
        "shape": list(img.shape[:2]), "seconds": round(dt, 3),
        "megapixels_per_s": round(img.shape[0] * img.shape[1] / dt / 1e6, 3),
        "output": args.output, "tile": args.tile,
    }
    if clean_255 is not None:
        report["psnr_noisy"] = round(psnr_255(
            clean_255, img_as_ubyte(np.clip(noisy, 0, 1)).astype(np.float32)), 3)
        report["psnr_denoised"] = round(psnr_255(clean_255, out_u8.astype(np.float32)), 3)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
