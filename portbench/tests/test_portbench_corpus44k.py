"""The 44.1 kHz batch cell (corpus44k.b2048) on the CPU at a small size of
its own: the cell runs through run.run_cell and is correct by its own
limits, the TF32 control is refused by them, and the direct body's device
reader finds nothing to read without a profile.

The rows keep the cell's 10 s: at 44.1 kHz the noise family's output
fills 97.6% of the capacity (1.33 L / rate) at 10 s and all of it at 2 or
4 s, where every such row would count as failed."""

import json

import pytest

from portbench import calibrate, judge, run
from portbench.tests.small import ROOT, SEED

CELL = "corpus44k.b2048"
SMALL = dict(batch=4, utterance_s=10.0, kept_calls=1, warmup_calls=1)


def limits():
    return json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())


@pytest.fixture(scope="module")
def result():
    return run.run_cell(ROOT, CELL, SEED, 0.2, False, "cpu", overrides=SMALL,
                        log=lambda *a: None)


def test_the_cell_runs_and_is_correct_by_its_limits(result):
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(limits())
    assert {"audio_s_per_s", "step_ms_p95", "setup_s"} <= set(result["metrics"])


def test_the_tf32_control_is_refused():
    r = calibrate.readings(CELL, SEED + 1, 0.2, True, "cpu", SMALL)
    ok, checks = judge.verdict(r, limits())
    assert not ok, checks


def test_direct_sum_reader_reads_none_without_a_profile(result):
    read = run.load_reader(ROOT / "portbench" / "metrics" / "direct_sum_device_ms.batch.py")
    assert "direct_sum_device_ms.batch" not in result["metrics"]
    assert read({"unit": "step"}) is None
    assert read({"unit": "step", "profile": None}) is None
    profile = {"calls": 2, "device_ops": {
        "void (anonymous namespace)::fft_kernel<240>(float const*, float*)": 0.004}}
    assert read({"unit": "step", "profile": profile}) is None
    profile["device_ops"]["void (anonymous namespace)::direct_kernel<true, 16>(float)"] = 0.2
    assert read({"unit": "step", "profile": profile}) == pytest.approx(100.0)
