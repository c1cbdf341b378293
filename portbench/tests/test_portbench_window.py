"""The window's arithmetic: a rate over all the work and all the time, a
p95 over every call, and the last line's keys."""

import json
import math

import pytest

from portbench import run, stats
from portbench.tests.small import ROOT, run_small


def reader(name):
    return run.load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_p95_is_over_every_call_by_nearest_rank():
    assert stats.p95([1.0] * 95 + [100.0] * 5) == 1.0
    assert stats.p95([1.0] * 94 + [100.0] * 6) == 100.0
    assert stats.p95([3.0]) == 3.0
    # A stall in the window shows in the tail, where a median would not.
    record = {"unit": "step", "times": [0.007] * 90 + [0.050] * 10}
    assert reader("step_ms_p95")(record) == pytest.approx(50.0)


def test_rates_take_all_the_work_over_all_the_time():
    # 100 steps of 128 x 10 s in a 7 s window, whatever the steps' spread.
    record = {"unit": "step", "calls": 100, "work_per_call": 1280.0, "window_s": 7.0,
              "times": [0.001] * 50 + [0.139] * 50}
    assert reader("audio_s_per_s")(record) == pytest.approx(100 * 1280 / 7.0)
    record = {"unit": "file", "calls": 3000, "work_per_call": 1.0, "window_s": 30.0,
              "times": [0.01] * 3000}
    assert reader("file_ms")(record) == pytest.approx(10.0)
    assert reader("audio_s_per_s")(record) is None  # a batch metric reads no file cell


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    result = run_small("corpus16k.b128", trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "dispatch_ms.batch" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"audio_s_per_s", "step_ms_p95", "setup_s"}
    for name, check in result["checks"].items():
        assert set(check) == {"value", "limit"} and math.isfinite(check["value"])
    line = json.dumps(run._finite(result), allow_nan=False)
    assert json.loads(line)["correct"] is True


def test_process_seconds_counts_from_the_process_start():
    assert 0.0 < run.process_seconds() < 24 * 3600
