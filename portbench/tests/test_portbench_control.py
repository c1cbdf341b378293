"""The comparison refuses what it must: the control (the reference with
every product in TF32, in the program's place) and a run whose timed path
is broken underneath; and it passes a sound run. At CPU sizes, with each
cell's own limits (portbench/limits/<cell>.json)."""

import json

import pytest
import torch

from portbench import calibrate, judge
from portbench.tests.small import ROOT, SEED, SMALL, run_small

CELLS = list(SMALL)


def limits(workload):
    return json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = run_small(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_refused(workload):
    r = calibrate.readings(workload, SEED + 1, 0.2, True, "cpu", SMALL[workload])
    ok, checks = judge.verdict(r, limits(workload))
    assert not ok, checks


def _alter_row(out):
    """One answer altered where it is produced: the second half of the
    first utterance's output silenced."""
    out = out.clone()
    n = int(out[0].nonzero().max()) + 1  # the buffer runs past the valid output
    out[0, n // 2: n] = 0.0
    return out


FAULTS = {
    # kernel 3's output for one utterance altered where it is produced
    "batch_answer_altered": ("speedy_tpu_torch.ops.kernels", "gather_synth",
                             lambda f: lambda *a: _alter_row(f(*a))),
    # half of the batch left out: rows past B/2 never synthesised
    "batch_half_left_out": ("speedy_tpu_torch.ops.kernels", "gather_synth",
                            lambda f: lambda *a: torch.cat(
                                [f(*a)[: a[0].shape[0] // 2],
                                 torch.zeros_like(f(*a)[a[0].shape[0] // 2:])])),
    # the speed law's answer altered where it is produced
    "batch_speeds_altered": ("speedy_tpu_torch.parallel.batch", "speed_from_tension_parallel",
                             lambda f: lambda *a, **k: f(*a, **k) * 1.02),
    # a file's samples altered where the grid engine produces them
    "file_answer_altered": ("speedy_tpu_torch.ops.wsola_fast", "_overlap_add",
                            lambda f: lambda *a: _alter_row(f(*a))),
    # the sequential law's answer altered where it is produced
    "file_speeds_altered": ("speedy_tpu_torch.pipeline", "speed_from_tension",
                            lambda f: lambda *a, **k: tuple(
                                [f(*a, **k)[0] * 1.02, f(*a, **k)[1]])),
}


@pytest.mark.parametrize("fault,workload", [
    ("batch_answer_altered", "corpus16k.b128"),
    ("batch_half_left_out", "corpus16k.b128"),
    ("batch_speeds_altered", "corpus16k.b4096"),
    ("file_answer_altered", "file16k.nonlinear"),
    ("file_answer_altered", "file16k.linear"),
    ("file_speeds_altered", "file16k.nonlinear"),
])
def test_a_broken_timed_path_is_refused(fault, workload, monkeypatch):
    import importlib

    module_name, attr, wrap = FAULTS[fault]
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    result = run_small(workload)
    assert not result["correct"], result["checks"]
