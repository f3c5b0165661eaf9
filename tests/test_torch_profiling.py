"""``irdu_tpu_torch.utils.profiling`` on the CPU: ``count_flops`` of a small
conv stack against 2·k²·C_in·C_out·H·W summed over its layers, and no
FLOPs for elementwise work; ``trace``
writing a Chrome trace that holds an ``annotate`` region; ``StepTimer.lap``
monotone and non-negative."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from irdu_tpu_torch.utils.profiling import TRACE_FILE, StepTimer, annotate, count_flops, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (k, C_in, C_out) per layer; padding k // 2 keeps H x W
LAYERS = ((3, 3, 8), (1, 8, 16), (5, 16, 4))


@pytest.mark.parametrize("hw", [(10, 12), (17, 9)])
def test_count_flops_of_a_conv_stack(hw):
    h, w = hw
    net = torch.nn.Sequential(*(torch.nn.Conv2d(ci, co, k, padding=k // 2)
                                for k, ci, co in LAYERS))
    x = torch.rand(1, 3, h, w)
    want = sum(2 * k * k * ci * co * h * w for k, ci, co in LAYERS)
    assert count_flops(net, x) == want
    assert count_flops(net, torch.rand(2, 3, h, w)) == 2 * want
    assert count_flops(lambda t: torch.relu(t) * 2 + 1, x) == 0


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    net = torch.nn.Conv2d(3, 4, 3, padding=1)
    with trace(str(tmp_path / "t")) as prof:
        with annotate("irdu_probe_region"):
            net(torch.rand(1, 3, 16, 16))
    assert prof is not None
    path = tmp_path / "t" / TRACE_FILE
    assert os.path.isfile(path)
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "irdu_probe_region" in names
    assert any("conv" in str(n) for n in names)


def test_step_timer_laps_are_monotone():
    timer = StepTimer()
    laps, marks = [], [time.time()]
    for pause in (0.0, 0.01, 0.02):
        time.sleep(pause)
        laps.append(timer.lap())
        marks.append(time.time())
    assert all(lap >= 0 for lap in laps)
    assert laps[2] >= 0.02 and laps[1] >= 0.01
    assert sum(laps) <= marks[-1] - marks[0] + 1e-3
