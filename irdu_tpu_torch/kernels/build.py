"""Build the port's CUDA kernels and bind them with ctypes.

All sources under ``csrc/`` go through ONE nvcc call into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libirdu_kernels_<hash>.so csrc/*.cu

The library is built at first use into ``_build/`` (git-ignored), keyed on a
hash of the sources and flags, and reused while they are unchanged. Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check_status`` turns a non-zero status into an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # name: (argtypes, restype)
    "irdu_block_stack": ((_P,) * 7 + (_I,) * 6 + (_L,) * 9 + (_I,) * 5 + (_P,), _I),
    "irdu_edge_weights": ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "irdu_fused_step": ((_P,) * 14 + (_I,) * 10 + (_P,), _I),
    "irdu_gg_unroll": ((_P,) * 12 + (_I,) * 7 + (_P,), _I),
    "irdu_gg_unroll_scratch_floats": ((_I, _I), _L),
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


def build() -> tuple[str, str, float]:
    """Compile the library unless it is already built. Returns its path, the
    compiler's messages (register and spill counts from ``-Xptxas -v``) and
    the seconds the build took (0 when it was already there)."""
    path = library_path()
    if os.path.isfile(path):
        return path, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path, proc.stdout + proc.stderr, seconds


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


def check_status(kernel: str, status: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = kernel_library().irdu_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({msg})")
