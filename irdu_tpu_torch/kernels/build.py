"""Build the port's CUDA kernels and bind them with ctypes.

Each source under ``csrc/`` is compiled by its own nvcc process, all started
together (one call for all sources compiles them one after another), and one
more nvcc call links the objects into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o _build/<name>.o        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libirdu_kernels_<hash>.so *.o

The library is built at first use into ``_build/`` (git-ignored), keyed on a
hash of the sources and flags, and reused while they are unchanged. Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check_status`` turns a non-zero status into an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # name: (argtypes, restype)
    "irdu_block_stack": ((_P,) * 7 + (_I,) * 6 + (_L,) * 9 + (_I,) * 6 + (_P,), _I),
    "irdu_block_stack_wgmma": ((_P,) * 8 + (_I,) * 9 + (_P,), _I),
    "irdu_block_stack_wgmma_error": ((), ctypes.c_char_p),
    "irdu_block_stack_wgmma_smem": ((_I, _I), _L),
    "irdu_block_stack_dw_mxu": ((_P,) * 7 + (_I,) * 8 + (_P,), _I),
    "irdu_block_stack_dw_mxu_error": ((), ctypes.c_char_p),
    "irdu_block_stack_dw_mxu_smem": ((_I, _I), _L),
    "irdu_edge_weights": ((_P,) * 3 + (_I,) * 11 + (_P,), _I),
    "irdu_edge_weights_smem": ((_I,) * 6, _L),
    "irdu_fused_step_hopper": ((_P,) * 14 + (_I,) * 12 + (_P,), _I),
    "irdu_fused_step_hopper_smem": ((_I,) * 4, _L),
    "irdu_gated_block": ((_P,) * 7 + (_I,) * 5 + (_L,) * 4 + (_I,) * 4 + (_P,), _I),
    "irdu_gated_block_error": ((), ctypes.c_char_p),
    "irdu_gg_unroll": ((_P,) * 12 + (_I,) * 9 + (_P,), _I),
    "irdu_gg_unroll_scratch_floats": ((_I, _I), _L),
    "irdu_gg_unroll_ctas_per_sm": ((_I, _I), _I),
    "irdu_pixel_unroll": ((_P,) * 8 + (_I,) * 7 + (_P,), _I),
    "irdu_pixel_unroll_scratch_floats": ((_I, _I), _L),
    "irdu_pixel_unroll_smem": ((_I, _I), _L),
    "irdu_pixel_unroll_ctas_per_sm": ((_I, _I), _I),
    "irdu_pixel_segment": ((_P,) * 9 + (_I,) * 9 + (_P,), _I),
    "irdu_pixel_segment_smem": ((_I,) * 4, _L),
    "irdu_system_matvec": ((_P,) * 8 + (_I,) * 6 + (_P,), _I),
    "irdu_system_matvec_smem": ((_I,), _L),
    "irdu_error_string": ((_I,), ctypes.c_char_p),
}

_library = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libirdu_kernels_{h.hexdigest()[:16]}.so")


def _nvcc(cmd) -> str:
    """Run one nvcc command; its messages, or an error with them."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple[str, str, float]:
    """Compile the library unless it is already built. Returns its path, the
    compiler's messages (register and spill counts from ``-Xptxas -v``, and
    a line "build: <source> <seconds> s" after each source's) and the
    seconds the build took (0 when it was already there)."""
    path = library_path()
    if os.path.isfile(path):
        return path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path[:-len('.so')]}.{os.getpid()}"
    nvcc = nvcc_path()
    units = [(src, f"{stem}.{os.path.basename(src)[:-len('.cu')]}.o")
             for src in _sources() if src.endswith(".cu")]
    t0 = time.perf_counter()

    def compile_unit(unit):  # its messages, then a line with its seconds
        src, obj = unit
        start = time.perf_counter()
        log = _nvcc([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj])
        return f"{log}build: {os.path.basename(src)} {time.perf_counter() - start:.3f} s\n"

    try:
        with ThreadPoolExecutor(len(units)) as pool:  # one compiler per source, all at once
            logs = list(pool.map(compile_unit, units))
        logs.append(_nvcc([nvcc, *ARCH_FLAGS, "-shared", "-o", f"{stem}.tmp",
                           *(obj for _, obj in units)]))
    finally:
        for _, obj in units:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(f"{stem}.tmp", path)  # atomic: a concurrent loader never sees half a file
    return path, "".join(logs), seconds


def ptxas_report(log: str, match: str) -> list[dict]:
    """The entry functions in ``-Xptxas -v`` messages whose mangled name
    holds ``match``: name, registers a thread, stack frame and spill stores
    and loads (bytes each)."""
    out, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = dict(name=entry.group(1)) if match in entry.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if cur is not None and frame:
            cur.update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                       spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if cur is not None and used:
            cur["registers"] = int(used.group(1))
            cur = None
    return out


def serial_build_seconds() -> float:
    """Seconds that one nvcc call compiling and linking every source takes,
    into a file it then removes: the one-call build, for comparison."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"serial.{os.getpid()}.so")
    t0 = time.perf_counter()
    try:
        _nvcc([nvcc_path(), *NVCC_FLAGS, "-shared", "-o", out,
               *(src for src in _sources() if src.endswith(".cu"))])
    finally:
        if os.path.exists(out):
            os.remove(out)
    return time.perf_counter() - t0


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(build()[0])
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _library = lib
    return _library


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def refuse_grad(kernel: str, *args) -> None:
    """Raise RuntimeError where a kernel would launch into a graph autograd
    records: the first tensor argument off the CPU (a CPU tensor takes the
    differentiable plain version), grad enabled and a tensor argument that
    requires grad. A kernel writes its output through a raw pointer, so the
    graph would end there without a word and the parameters upstream get no
    gradient. There is no fallback: train with the kernels off."""
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    if (tensors and tensors[0].device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{kernel}: a kernel launch cannot carry gradients, and an input requires "
            "grad; run the model's plain versions with "
            "irdu_tpu_torch.models.registry.set_kernels(model, False), or call it under "
            "torch.inference_mode()")


def check_status(kernel: str, status: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = kernel_library().irdu_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({msg})")


if __name__ == "__main__":
    # python -m irdu_tpu_torch.kernels.build: build the library (0 s when it is
    # already built), then time the one-call build of the same sources
    lib_path, _, parallel_s = build()
    print(json.dumps({"library": lib_path, "parallel_s": round(parallel_s, 3),
                      "serial_s": round(serial_build_seconds(), 3)}))
