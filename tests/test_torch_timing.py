"""``kernels/timing.timed_device_us``, which picks the device time of the
timed calls out of a torch.profiler trace, on hand-made traces: device events
linked to their launch calls by correlation id, with the trace's device clock
placed early, on time or late against the host's.
"""

from __future__ import annotations

import pytest

from irdu_tpu_torch.kernels.timing import timed_device_us


def _trace(skew_us, reps=3, pad=2, unlinked=False):
    """``pad`` untimed then ``reps`` timed calls 100 µs apart on the host,
    each under a "call" annotation and launching a 20 µs kernel that starts
    5 µs after its launch plus ``skew_us``; the "timed" annotation spans the
    timed calls."""
    spans, t = [], 1000.0
    for i in range(pad + reps):
        if i == pad:
            spans.append(dict(ph="X", cat="user_annotation", name="timed", ts=t - 1.0,
                              dur=100.0 * reps))
        spans.append(dict(ph="X", cat="user_annotation", name="call", ts=t - 0.5, dur=4.0))
        spans.append(dict(ph="X", cat="cuda_driver", name="cuLaunchKernel", ts=t, dur=3.0,
                          args=dict(correlation=i)))
        spans.append(dict(ph="X", cat="kernel", name="k", ts=t + 5.0 + skew_us, dur=20.0,
                          args=dict(correlation=i)))
        t += 100.0
    if unlinked:
        spans.append(dict(ph="X", cat="gpu_memset", name="m", ts=t + skew_us, dur=7.0,
                          args=dict(correlation=99)))
    return spans


@pytest.mark.parametrize("skew_us", [-5000.0, -150.0, 0.0, 150.0])
def test_launch_attribution_ignores_the_device_clock(skew_us):
    got = timed_device_us(_trace(skew_us))
    assert got["by_launch"] == 60.0
    assert got["matched"] == 3 and got["before"] == 2 and got["unlinked"] == 0
    assert got["per_call"] == [1] * 5 and got["complete"]
    assert got["lead_us"] == pytest.approx(5.0 + skew_us)


def _without_kernel(spans, correlation):
    return [e for e in spans if e["cat"] != "kernel" or e["args"]["correlation"] != correlation]


@pytest.mark.parametrize("lost,complete,by_launch", [(0, True, 60.0), (1, False, 60.0),
                                                     (2, False, 40.0), (4, False, 40.0)])
def test_a_session_whose_timed_calls_lost_events_is_incomplete(lost, complete, by_launch):
    """A trace can lack a session's first device events: losing the first
    untimed call's leaves the session whole; losing the last untimed call's
    leaves nothing to hold the timed calls against; losing a timed call's
    voids it."""
    got = timed_device_us(_without_kernel(_trace(0.0), lost))
    assert got["complete"] == complete and got["by_launch"] == by_launch


@pytest.mark.parametrize("skew_us,by_clock", [(-5000.0, 0.0), (0.0, 60.0), (150.0, 80.0)])
def test_clock_attribution_follows_the_device_clock(skew_us, by_clock):
    """What the clock alone gives: nothing when the device clock runs early
    by more than the timed window, pad calls counted when it runs late."""
    assert timed_device_us(_trace(skew_us))["by_clock"] == by_clock


def test_an_unlinked_device_event_leaves_only_the_clock():
    got = timed_device_us(_trace(0.0, unlinked=True))
    assert got["unlinked"] == 1 and got["by_launch"] is None
    assert got["by_clock"] == 67.0


def test_no_annotation_no_time():
    spans = [e for e in _trace(0.0) if e["name"] != "timed"]
    got = timed_device_us(spans)
    assert got["marks"] == 0 and got["by_clock"] == 0.0 and got["by_launch"] is None


def test_chip_smoke_counts_how_each_time_was_taken(tmp_path, monkeypatch):
    """chip_smoke.py's ``device_ms`` line over three sessions: one linked
    with the device clock early, and two void ones, with an unlinked event
    and with a timed call that lost its device event."""
    import importlib.util
    import json
    import os

    from irdu_tpu_torch.kernels import timing

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lossy = _without_kernel(_trace(0.0), 4)
    sessions = [dict(timed_device_us(t), attempt=0, reps=3, pad=2)
                for t in (_trace(-150.0), _trace(0.0, unlinked=True), lossy)]
    monkeypatch.setattr(timing, "SESSIONS", sessions)
    monkeypatch.setattr(smoke, "OUT_DIR", str(tmp_path))
    got = smoke.device_ms_sessions()["device_ms"]
    # the early clock's sum: 20 of the launch sum's 60 µs
    assert got == dict(sessions=3, void=2, short_start=1, events_after_sleep=0,
                       lead_us=[-145.0, 5.0], max_gap=pytest.approx(2 / 3))
    with open(tmp_path / "device_ms_sessions.json") as fh:
        assert len(json.load(fh)) == 3
