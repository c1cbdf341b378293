"""The 22.05 kHz batch cell (corpus22k.b64) on the CPU at a small size of
its own: the cell runs through run.run_cell and is correct by its own
limits, the TF32 control is refused by them, and the FFT body's device
reader finds nothing to read without a profile and reads fft_kernel by
name.

The rows keep the cell's 10 s: at 22.05 kHz the noise family's output
fills 93.8% of the capacity (1.33 L / rate) at 10 s, 94.5% at 4 s."""

import json

import pytest

from portbench import calibrate, judge, run
from portbench.tests.small import ROOT, SEED

CELL = "corpus22k.b64"
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


def test_fft_body_reader_reads_none_without_a_profile_and_the_body_by_name(result):
    read = run.load_reader(ROOT / "portbench" / "metrics" / "fft_body_device_ms.batch.py")
    assert "fft_body_device_ms.batch" not in result["metrics"]
    assert read({"unit": "step"}) is None
    assert read({"unit": "step", "profile": None}) is None
    assert read({"unit": "call", "profile": {"calls": 1, "device_ops": {}}}) is None
    profile = {"calls": 2, "device_ops": {
        "void (anonymous namespace)::direct_kernel<true, 16>(float)": 0.2,
        "void at::native::vectorized_elementwise_kernel<4, fft_kernel_like>(int)": 0.5}}
    assert read({"unit": "step", "profile": profile}) is None
    profile["device_ops"]["void (anonymous namespace)::fft_kernel<330, 1>(float const*)"] = 4e-4
    assert read({"unit": "step", "profile": profile}) == pytest.approx(0.2)
