"""Device time of a kernel call on the card, with no host work in the window.

CUDA events around a run of calls also time the wrappers' host work, which is
most of a small call's time. ``device_ms`` instead runs the calls under
torch.profiler and sums the durations of the kernels and copies that the
timed calls launched.
``chip_smoke.py``, ``kernels/plan_sweep.py`` and ``kernels/ab_sources.py`` (in
the other tree's process too, loaded by path) use it. It imports torch only.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a trace
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # trace categories of CUDA API calls
SESSIONS: list[dict] = []  # one record per profiler session of device_ms, in order


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


def timed_device_us(spans: list[dict], mark: str = "timed", call: str = "call") -> dict:
    """The device time (µs) of the work launched inside the ``mark``
    annotation. ``by_launch`` sums the device events whose correlation id is
    that of a CUDA API launch call made inside the annotation: both lie on
    the host's clock, so it holds however the trace places device time
    against host time. It is None when some device event of the trace links
    to no launch call (``unlinked``), since that event's call could lie in the
    annotation. ``by_clock`` sums the device events that start after the
    annotation does, on the trace's shared clock, for comparison: the trace
    can place device events before their launches. ``matched`` and ``before``
    count the device events launched inside and before the annotation;
    ``per_call`` those launched inside each ``call`` annotation, in order.
    ``complete``: every call inside ``mark`` launched as many device events
    as the last call before it, and that is at least one (a trace can lack a
    session's first device events). ``lead_us`` is the least time from a
    launch call to the start of its device event (negative when the trace
    puts device time early)."""
    ann = ("user_annotation", "cpu_op")
    marks = [e for e in spans if e.get("name") == mark and e.get("cat") in ann]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in spans
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    launched_at = [launch_ts.get(e.get("args", {}).get("correlation")) for e in device]
    unlinked = sum(t is None for t in launched_at)
    out = dict(marks=len(marks), device=len(device), unlinked=unlinked, matched=0, before=0,
               per_call=[], complete=False, by_launch=None, by_clock=0.0, lead_us=None)
    if not marks:
        return out
    t0 = min(e["ts"] for e in marks)
    t1 = max(e["ts"] + e["dur"] for e in marks)
    matched = [e for e, t in zip(device, launched_at) if t is not None and t0 <= t <= t1]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e.get("name") == call and e.get("cat") in ann)
    per_call = [sum(t is not None and a <= t <= b for t in launched_at) for a, b in calls]
    timed = [n for (a, _), n in zip(calls, per_call) if a >= t0]
    last_pad = ([n for (a, _), n in zip(calls, per_call) if a < t0] or [0])[-1]
    out.update(matched=len(matched), before=sum(t is not None and t < t0 for t in launched_at),
               per_call=per_call,
               complete=bool(timed) and last_pad > 0 and all(n == last_pad for n in timed),
               by_clock=float(sum(e["dur"] for e in device if e["ts"] >= t0)))
    if not unlinked:
        out["by_launch"] = float(sum(e["dur"] for e in matched))
    if matched:
        out["lead_us"] = float(min(e["ts"] - launch_ts[e["args"]["correlation"]]
                                   for e in matched))
    return out


def events_after_sleep_ms(fn, reps: int) -> float | None:
    """The device time of one call of ``fn`` by CUDA events, with the host's
    work kept out of the window: a sleep kernel holds the stream while the
    host queues the ``reps`` calls, so they run back to back. None if the
    sleep ended before the host had queued them all."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def device_ms(fn, reps: int, pad: int = 5, sessions: int = 4) -> float:
    """The device time of one call of ``fn``: torch.profiler over ``pad``
    untimed calls, a synchronize, then ``reps`` calls under a "timed"
    annotation, each call under a "call" one; the summed durations of the
    kernels and copies the timed calls launched (``timed_device_us``'s
    ``by_launch``), over ``reps``. A session is void when a device event
    links to no launch call, when a timed call lacks device events the last
    untimed call had, or when it shows no device time; it is run again, up
    to ``sessions`` times, and then the time is taken by
    ``events_after_sleep_ms``. It raises only if that fails too. Each
    session's record goes to ``SESSIONS``."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                with record_function("call"):
                    fn()
            torch.cuda.synchronize()
            with record_function("timed"):
                for _ in range(reps):
                    with record_function("call"):
                        fn()
                torch.cuda.synchronize()
        got = timed_device_us(trace_spans(prof))
        SESSIONS.append(dict(got, attempt=attempt, reps=reps, pad=pad))
        if got["complete"] and got["by_launch"]:
            return got["by_launch"] / reps / 1e3
        print(f"device_ms: session {attempt} is void: {got}", file=sys.stderr)
    ms = events_after_sleep_ms(fn, reps)
    SESSIONS.append(dict(attempt=sessions, reps=reps, events_after_sleep_ms=ms))
    if ms is None:
        raise RuntimeError(f"the profiler recorded no device time in {sessions} sessions, "
                           "and the host could not queue the calls ahead of the card")
    return ms
