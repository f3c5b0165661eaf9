"""Device time of a kernel call on the card, with no host work in the window.

CUDA events around a run of calls also time the wrappers' host work, which is
most of a small call's time. ``device_ms`` instead runs the calls under
torch.profiler and sums the durations of the kernels and copies in the timed
part of its trace.
``chip_smoke.py``, ``kernels/plan_sweep.py`` and ``kernels/ab_sources.py`` (in
the other tree's process too, loaded by path) use it. It imports torch only.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a trace


def trace_spans(prof) -> list[dict]:
    """The complete ("X") events of a finished torch.profiler session, from
    its exported Chrome trace (µs timestamps and durations)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_ms(fn, reps: int, pad: int = 5) -> float:
    """The device time of one call of ``fn``: torch.profiler over ``pad``
    untimed calls, a synchronize, then ``reps`` calls under a "timed"
    annotation; the summed durations of the kernels and copies that start
    after the annotation does, over ``reps``. A trace can lack the first few
    device events of a session (seen after many sessions in one process), so
    those fall among the untimed calls. A session whose timed part holds no
    device activity is run again, up to 3 times; then it raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                fn()
            torch.cuda.synchronize()
            with record_function("timed"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        spans = trace_spans(prof)
        marks = [e["ts"] for e in spans if e.get("name") == "timed"
                 and e.get("cat") in ("user_annotation", "cpu_op")]
        if marks:
            total = sum(e["dur"] for e in spans
                        if e.get("cat") in DEVICE_CATS and e["ts"] >= min(marks))
            if total > 0:
                return total / reps / 1e3
    raise RuntimeError("the profiler recorded no device time in 3 sessions")
