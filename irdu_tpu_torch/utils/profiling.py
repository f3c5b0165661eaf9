"""Tracing, annotations, FLOP counts and a step timer (counterpart:
``irdu_tpu/utils/profiling.py``).

``trace`` records ``torch.profiler``'s CPU and CUDA activities and writes a
Chrome trace (``chrome://tracing``, Perfetto); ``annotate`` names a region
inside it; ``count_flops`` counts with ``torch.utils.flop_counter``;
``StepTimer`` is the train log's wall-clock lap.

JAX's ``enable_compile_cache`` has no counterpart here: the port compiles no
graph at run time, and its kernels' compile cache is their hashed build
directory (``kernels/_build/``, ``data/native/_build/``), reused while the
sources and flags are unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block, CPU and (where there is a card) CUDA activities,
    and write the Chrome trace to ``log_dir/trace.json``:
    ``with trace("runs/t"): fn()``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """Total FLOPs of ``fn(*args, **kwargs)`` by
    ``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add counts 2).

    It counts the aten operators it knows (convolutions, matrix products,
    attention) and nothing else, so run it on the plain versions
    (``models.registry.set_kernels(model, False)``): a kernel wrapper's
    launch is opaque to it and counts 0, as are its elementwise ops."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


class StepTimer:
    """Rolling per-step wall-clock timer of the train log
    (``iter=.. time=..``)."""

    def __init__(self):
        self._t = time.time()

    def lap(self) -> float:
        """Seconds since the previous lap (or since construction)."""
        now = time.time()
        dt = now - self._t
        self._t = now
        return dt
