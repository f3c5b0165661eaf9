"""Ahead-of-time export for serving (counterpart: ``irdu_tpu/deploy.py``):
the model's NHWC forward as a ``torch.export`` artifact with the weights
inside, reloaded without any model code, and run.

    python -m irdu_tpu_torch.deploy --model flagship --size 512 --output flagship_512.pt2 \
        [--weights W.npz] [--batch 1] [--cg-iters 3] [--filter-scales 1,2,3] [--weight-int8]

The artifact is ``torch.export.save``'s ``.pt2`` archive. Every kernel call
of the forward is one ``irdu::`` operator node of its graph
(``kernels/library.py``): on the card it launches the kernel, on the CPU it
runs the kernel's plain version. Beside the program the archive carries a
JSON entry (``META``): the model, the weights, the input shape, dtype and
device, whether the pointwise weights are int8, and the kernel operators
with their counts.

* Shapes are static, as JAX's are: one artifact per (batch, H, W) bucket, H
  and W multiples of 16. Serving another size is the protocol's reflect pad
  to the bucket, run, crop (``eval/harness.py``).
* An artifact exported on the card runs on the card; ``load_exported``
  refuses it where there is no CUDA device (JAX's platform check) and never
  moves it to the CPU.
* ``load_exported`` imports the operator registrations and no model code
  (no ``irdu_tpu_torch.models``). Unlike JAX's artifact, which needs only
  ``jax``, a consumer needs this package's operator library to load one.
* ``pointwise_int8`` keeps every weight whose flax kernel is 2-D (the 1×1
  convs, the 2×2 down- and up-samples) as an int8 buffer with an f32
  per-output-channel scale (``utils.weights.quantize_kernel_int8``, JAX's
  scheme), dequantized inside the forward as JAX does: q·s in f32, then the
  model's dtype.
"""

from __future__ import annotations

import argparse
import collections
import copy
import io
import json
import os
import sys
import zipfile

import torch

__all__ = ["export_forward", "load_exported", "quantize_pointwise"]

META = "irdu_meta.json"
FORMAT = "irdu_tpu_torch.deploy/1"


class _Int8Weight:
    """A conv whose ``weight`` is its int8 flax kernel ``weight_q`` times the
    f32 per-output-channel ``weight_scale``, cast to ``weight_dtype`` and
    laid out by the module's ``kernel_to_torch``."""

    @property
    def weight(self):
        w = (self.weight_q.float() * self.weight_scale).to(self.weight_dtype)
        return self.kernel_to_torch(w)


_INT8_CLASSES: dict[type, type] = {}


def quantize_pointwise(model: torch.nn.Module, dtype: torch.dtype) -> int:
    """Cast ``model`` to ``dtype`` in place, with every ``weight`` parameter
    whose flax kernel is 2-D (its module has ``kernel_from_torch``) in int8:
    the parameter becomes the int8 buffer ``weight_q`` (flax layout) and the
    f32 buffer ``weight_scale``, quantized from its values before the cast,
    and ``weight`` reads back their product in ``dtype``. Returns the
    number quantized."""
    from irdu_tpu_torch.utils.weights import quantize_kernel_int8

    quantized = []
    for mod in model.modules():
        w = mod._parameters.get("weight")
        if w is None or not hasattr(mod, "kernel_from_torch"):
            continue
        kernel = mod.kernel_from_torch(w.detach())
        if kernel.dim() == 2:
            quantized.append((mod, w.device, *quantize_kernel_int8(kernel.float().cpu().numpy())))
            del mod._parameters["weight"]
    model.to(dtype=dtype)
    for mod, device, q, s in quantized:  # after the cast: the scales stay f32
        mod.register_buffer("weight_q", torch.tensor(q, device=device))
        mod.register_buffer("weight_scale", torch.tensor(s, device=device))
        mod.weight_dtype = dtype
        cls = type(mod)
        mod.__class__ = _INT8_CLASSES.setdefault(
            cls, type(f"Int8{cls.__name__}", (_Int8Weight, cls), {}))
    return len(quantized)


def kernel_ops(program) -> dict[str, int]:
    """The ``irdu::`` operator nodes of an exported program's graph, by name."""
    names = (str(n.target).split(".")[1] for n in program.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("irdu."))
    return dict(sorted(collections.Counter(names).items()))


def export_forward(model: torch.nn.Module, batch: int, height: int, width: int, *,
                   dtype: torch.dtype = torch.bfloat16, path: str | None = None,
                   pointwise_int8: bool = False, info: dict | None = None) -> bytes:
    """Export ``model``'s forward on a (batch, height, width, 3) input of
    ``dtype`` on the model's device, with a copy of its weights in
    ``dtype`` inside (with ``pointwise_int8``, quantized first from the
    weights as they are). Returns the archive's bytes, also written to
    ``path`` if given; ``info`` (e.g. model and weights names) goes into its
    metadata. The model itself is not changed."""
    if height % 16 or width % 16:
        raise ValueError("export shapes must be /16 (the model's resample "
                         f"factor); got {height}x{width}")
    model = copy.deepcopy(model).eval().requires_grad_(False)
    device = next(model.parameters()).device
    n_int8 = quantize_pointwise(model, dtype) if pointwise_int8 else 0
    if not pointwise_int8:  # (quantize_pointwise casts around the f32 scales)
        model.to(dtype=dtype)
    x = torch.zeros((batch, height, width, 3), dtype=dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    meta = dict(info or {}, format=FORMAT, input=[batch, height, width, 3],
                dtype=str(dtype).removeprefix("torch."), device=device.type,
                int8=bool(pointwise_int8), int8_tensors=n_int8, kernel_ops=kernel_ops(program))
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def read_meta(blob: bytes) -> dict:
    """The metadata of an ``export_forward`` archive; ValueError for anything else."""
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            name = next((n for n in zf.namelist() if n.endswith(f"/extra/{META}")), None)
            meta = json.loads(zf.read(name)) if name else None
    except (zipfile.BadZipFile, ValueError) as exc:
        raise ValueError("not an irdu_tpu_torch export artifact") from exc
    if not isinstance(meta, dict) or meta.get("format") != FORMAT:
        raise ValueError("not an irdu_tpu_torch export artifact")
    return meta


def load_exported(path_or_bytes):
    """Load an ``export_forward`` artifact (a path or its bytes) as
    callable(x) → the denoised batch, a tensor on the artifact's device.
    ``x`` (numpy or tensor) must have the exported shape; it is cast to the
    artifact's dtype and moved to its device. The callable carries
    ``input_shape``, ``input_dtype`` and ``meta``.

    Raises ValueError on a file that is not such an artifact, and on an
    artifact exported for CUDA where no CUDA device is present."""
    from irdu_tpu_torch.kernels import library

    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as fh:
            blob = fh.read()
    else:
        blob = bytes(path_or_bytes)
    meta = read_meta(blob)
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise ValueError("the artifact was exported for CUDA, and no CUDA device is "
                         "present; export it again on this platform")
    library.load_all()  # the operators the graph calls
    module = torch.export.load(io.BytesIO(blob)).module()
    shape, dtype = tuple(meta["input"]), getattr(torch, meta["dtype"])
    device = torch.device(meta["device"])

    def run(x):
        x = torch.as_tensor(x)
        if tuple(x.shape) != shape:
            raise ValueError(f"expected input {shape}, got {tuple(x.shape)}")
        with torch.no_grad():
            return module(x.to(device=device, dtype=dtype))

    run.input_shape, run.input_dtype, run.meta = shape, dtype, meta
    return run


def main(argv=None, device: str = "cuda"):
    """CLI: put a weight snapshot into an artifact at one static (batch,
    size, size) bucket, on the card in bf16 (``device="cpu"``: f32 on the
    CPU), and print one JSON line (JAX's keys)."""
    from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, FAMILY, load_model

    ap = argparse.ArgumentParser(prog="python -m irdu_tpu_torch.deploy",
                                 description=main.__doc__)
    ap.add_argument("--model", default="flagship", choices=FAMILY)
    ap.add_argument("--weights", default=None,
                    help="npz snapshot (default: predict.DEFAULT_WEIGHTS of the model)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--size", type=int, default=512, help="square input bucket (px, /16)")
    ap.add_argument("--cg-iters", type=int, default=3)
    ap.add_argument("--filter-scales", default=None,
                    help="comma list of the scales to filter (default: all four)")
    ap.add_argument("--weight-int8", action="store_true",
                    help="keep the 2-D kernels as int8 and a per-channel scale in the "
                         "artifact, dequantized in its forward")
    ap.add_argument("--output", required=True, help="the artifact's path (.pt2)")
    args = ap.parse_args(argv)

    weights = args.weights or DEFAULT_WEIGHTS[args.model]
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    fs = (None if args.filter_scales is None
          else tuple(int(s) for s in args.filter_scales.split(",")))
    try:
        # int8 is quantized from the snapshot's values, before the cast to dtype
        model = load_model(weights, device, torch.float32 if args.weight_int8 else dtype,
                           name=args.model, cg_iters=args.cg_iters, filter_scales=fs)
        blob = export_forward(model, args.batch, args.size, args.size, dtype=dtype,
                              path=args.output, pointwise_int8=args.weight_int8,
                              info=dict(model=args.model, weights=os.path.basename(weights)))
    except ValueError as exc:
        sys.exit(str(exc))
    print(json.dumps({
        "artifact": args.output, "bytes": len(blob), "model": args.model, "weights": weights,
        "weight_int8": bool(args.weight_int8), "input": [args.batch, args.size, args.size, 3],
        "dtype": str(dtype).removeprefix("torch."), "backend": torch.device(device).type}))


if __name__ == "__main__":
    main()
