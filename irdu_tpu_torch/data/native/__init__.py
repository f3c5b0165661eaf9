"""The native (C++) batch path, bound with ctypes (counterpart:
``irdu_tpu/data/native/__init__.py``, with its functions, signatures and
dist-mode table).

``irdu_data.cc`` assembles whole (noisy, clean) batches in C++ threads with
numpy's legacy RNG reproduced bit for bit (SeedSequence → MT19937 → polar
gaussians, masked-rejection ``randint``, ``choice``), so that a batch equals
what ``PatchDataset.__getitem__`` stacks, bitwise.

The build differs from JAX's, which writes ``libirdu_data.so`` beside its
source in every process that finds it stale:

    $CXX (else g++) -O3 -std=c++17 -shared -fPIC -pthread irdu_data.cc \
        -o _build/libirdu_data_<hash>.so.<pid>.<thread>.tmp
    os.replace(<that file>, _build/libirdu_data_<hash>.so)

It builds at first use (never at import), into ``_build/`` beside this file
(git-ignored), keyed on a hash of the source and the flags, under a name of
its own process and thread that ``os.replace`` then moves into place: no
process loads a half-written file, and two processes that build at once both
end with a whole library. A build or load that fails is remembered for that
library path: ``available()`` is then False and ``load_error()`` says why;
the loader's "native" backend raises with it rather than falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "irdu_data.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL | str] = {}  # library path → library, or its error


def compiler() -> str:
    """``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libirdu_data_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library into ``BUILD_DIR`` unless it is there; returns its
    path. RuntimeError, with the compiler's messages, when the compiler is
    missing or fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run the C++ compiler {cmd[0]!r}: {exc}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.irdu_rng_probe.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.irdu_rng_probe.restype = None
    lib.irdu_make_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),            # images
        ctypes.POINTER(ctypes.c_int32),             # img_hw
        ctypes.POINTER(ctypes.c_int32),             # crops
        ctypes.POINTER(ctypes.c_uint8),             # pad_flags
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # n, ph, pw
        ctypes.c_uint64,                            # seed
        ctypes.POINTER(ctypes.c_int64),             # indices
        ctypes.c_int32, ctypes.c_int32,             # use_aug, dist_mode
        ctypes.POINTER(ctypes.c_double),            # levels
        ctypes.POINTER(ctypes.c_double),            # probs
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32,  # n_lv, lam, clip
        ctypes.POINTER(ctypes.c_float),             # out_noisy
        ctypes.POINTER(ctypes.c_float),             # out_clean
        ctypes.c_int32,                             # n_threads
    ]
    lib.irdu_make_pairs.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL | None:
    """The library of ``BUILD_DIR``, built and loaded at first use; None
    when that failed (the reason stays in ``_loaded``)."""
    path = library_path()
    with _lock:
        if path not in _loaded:
            try:
                _loaded[path] = _bind(ctypes.CDLL(build()))
            except (OSError, RuntimeError, AttributeError) as exc:  # no compiler, build, load
                _loaded[path] = f"{type(exc).__name__}: {exc}"
        got = _loaded[path]
    return None if isinstance(got, str) else got


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {load_error()}")
    return lib


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why the library could not be built or loaded; None when it is loaded."""
    _load()
    got = _loaded.get(library_path())
    return got if isinstance(got, str) else None


def rng_probe(seed: int, idx: int, kind: int, n: int, probs=None) -> np.ndarray:
    """Test hook: n draws of ``kind`` from the (seed, idx) item RNG.
    kind: 0 raw u32, 1 randint(0,7), 2 normal, 3 random_sample, 4 choice."""
    lib = _library()
    out = np.empty(n, np.float64)
    p = np.ascontiguousarray(probs if probs is not None else [], np.float64)
    lib.irdu_rng_probe(
        seed, idx, kind, n,
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


_DIST_MODES = {
    "none": 0, "": 0, None: 0,
    "addictive_noise": 1,
    "addictive_noise_scale": 2,
    "vary_addictive_noise": 3,
}


def make_pairs(
    images: list[np.ndarray],
    crops: np.ndarray,          # (n, 2) int32 row/col
    pad_flags: np.ndarray,      # (n,) uint8
    indices: np.ndarray,        # (n,) int64 dataset indices
    *,
    patch_size: tuple[int, int],
    seed: int,
    use_aug: bool,
    dist_mode: str,
    lambda_noise,
    clip: bool,
    num_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble (noisy, clean) float32 batches natively.

    ``images[k]`` is the uint8 HWC (3-channel, C-contiguous) source image of
    item k. Bit-exact with ``PatchDataset.__getitem__`` for every item.
    """
    lib = _library()

    n = len(images)
    ph, pw = patch_size
    oh, ow = (ph // 16) * 16, (pw // 16) * 16

    mode = _DIST_MODES[dist_mode] if dist_mode in _DIST_MODES else None
    if mode is None:
        raise ValueError(f"native path does not support dist_mode={dist_mode}")
    if mode == 3:
        levels, probs = lambda_noise
        levels = np.ascontiguousarray(levels, np.float64)
        probs = np.ascontiguousarray(probs, np.float64)
        lam = 0.0
    else:
        levels = np.zeros(1, np.float64)
        probs = np.zeros(1, np.float64)
        lam = float(lambda_noise) if mode else 0.0

    img_ptrs = (ctypes.c_void_p * n)()
    img_hw = np.empty((n, 2), np.int32)
    for k, im in enumerate(images):
        if not (im.dtype == np.uint8 and im.ndim == 3 and im.shape[2] == 3
                and im.flags["C_CONTIGUOUS"]):
            raise ValueError("the native path needs C-contiguous uint8 HWC 3-channel images, "
                             f"got {im.dtype} {im.shape}")
        img_ptrs[k] = im.ctypes.data
        img_hw[k] = im.shape[:2]

    crops = np.ascontiguousarray(crops, np.int32)
    pad_flags = np.ascontiguousarray(pad_flags, np.uint8)
    indices = np.ascontiguousarray(indices, np.int64)
    out_noisy = np.empty((n, oh, ow, 3), np.float32)
    out_clean = np.empty((n, oh, ow, 3), np.float32)

    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)

    rc = lib.irdu_make_pairs(
        img_ptrs,
        img_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pad_flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, ph, pw, seed,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(use_aug), mode,
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(levels), lam, int(clip),
        out_noisy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_clean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads)
    if rc != 0:
        raise RuntimeError(f"irdu_make_pairs failed: rc={rc}")
    return out_noisy, out_clean
