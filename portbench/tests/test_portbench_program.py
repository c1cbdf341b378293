"""The program's own spans in a trace: a synthetic chrome trace holding
the harness's pb: ranges and the program's speedy: ranges. The harness's
record (profiling.reduce) is what it is without the program's ranges, and
program_spans.reduce holds known sums, and program_spans._profile counts
the program's transfers over the profiled calls only."""

import json

import pytest

from portbench import profiling, program_spans, run
from portbench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _events(outer="batch"):
    """Two calls in a 1000 us window, each in a speedy:<outer> span; the
    first with an analysis layer holding one lpf_tables sync; one rg sync
    a call; a kernel launched in each call."""
    return [
        _x("pb:window", 0, 1000),
        _x("pb:call", 0, 500), _x("pb:call", 500, 500),
        _x("pb:analysis", 10, 200),
        _x(f"speedy:{outer}", 5, 400), _x(f"speedy:{outer}", 505, 400),
        _x("speedy:analysis", 12, 190),
        _x("speedy:sync:lpf_tables", 20, 30),
        _x("speedy:sync:rg", 250, 10), _x("speedy:sync:rg", 750, 20),
        _x("cudaLaunchKernel", 60, 5, cat="cuda_runtime", correlation=1),
        _x("cudaLaunchKernel", 560, 5, cat="cuda_runtime", correlation=2),
        _x("kernel_a", 100, 50, cat="kernel", correlation=1),
        _x("kernel_b", 600, 100, cat="kernel", correlation=2),
    ]


def _strip(events):
    return [e for e in events if not e["name"].startswith(program_spans.PROGRAM)]


def _record(prof, unit):
    return {"unit": unit, "profile": dict(prof, calls=2), "dispatch": [0.005, 0.006],
            "setup_s": 9.0, "times": [0.007, 0.008],
            "shapes": dict(B=128, L=160000, W=240, T=999, taps=246, min_period=40,
                           max_period=246, n_grid=209)}


def _reader(name):
    return run.load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_the_harness_record_is_what_it_is_without_the_program_spans():
    with_program = profiling.reduce(_events())
    without = profiling.reduce(_strip(_events()))
    assert with_program == without
    assert with_program["span_device_s"] == {"analysis": pytest.approx(50e-6),
                                             "other": pytest.approx(100e-6)}
    for m in BENCH["per_layer"]:
        for unit in ("step", "file"):
            read = _reader(m["name"])
            assert read(_record(with_program, unit)) == read(_record(without, unit)), m["name"]
    assert profiling.breakdown(with_program) == profiling.breakdown(without)


def test_the_program_part_holds_the_known_sums():
    prog = program_spans.reduce(_events())
    assert prog["outer_host_s"] == {"batch": pytest.approx(800e-6)}
    assert prog["sync_host_s"] == {"lpf_tables": pytest.approx(30e-6),
                                   "rg": pytest.approx(30e-6)}
    assert prog["sync_spans"] == {"lpf_tables": 1, "rg": 2}
    assert prog["issue_host_s"] == pytest.approx(740e-6)
    # Idle: [0, 100], [150, 600], [700, 1000] us, by the innermost span.
    want = {"between_layers": 200e-6, "batch": 480e-6, "analysis": 110e-6,
            "sync:lpf_tables": 30e-6, "sync:rg": 30e-6}
    assert prog["idle_gaps"] == {k: pytest.approx(v) for k, v in want.items()}
    out = program_spans.breakdown(prog)
    assert out["idle_gaps"][0] == ["batch", pytest.approx(480e-6)]
    assert ["sync:rg", pytest.approx(30e-6)] in out["idle_gaps"]
    assert out["sync_host_s"] == [["lpf_tables", pytest.approx(30e-6), 1],
                                  ["rg", pytest.approx(30e-6), 2]]


@pytest.mark.parametrize("outer,unit,names", [
    ("batch", "step", ("host_syncs_per_step.batch", "sync_wait_ms.batch",
                       "host_issue_ms.batch")),
    ("file", "file", ("host_syncs_per_call.file", "sync_wait_ms.file", "host_issue_ms.file")),
])
def test_the_readings_a_call(outer, unit, names):
    prog = program_spans.reduce(_events(outer))
    got = program_spans.readings(prog, {"lpf_tables": 16, "rg": 2}, 2, unit)
    assert list(got) == list(names)
    assert got[names[0]] == 9.0
    assert got[names[1]] == pytest.approx(0.03)
    assert got[names[2]] == pytest.approx(0.37)
    assert program_spans.readings(prog, {}, 2, unit)[names[0]] == 0.0  # no sync is a reading
    other = "file" if unit == "step" else "step"
    assert program_spans.readings(prog, {}, 2, other) == {}


def test_a_program_without_spans_reads_nothing():
    prog = program_spans.reduce(_strip(_events()))
    assert prog["outer_host_s"] == {} and prog["idle_gaps"] == {}
    assert program_spans.breakdown(prog) is None
    assert program_spans.readings(prog, {}, 2, "step") == {}


@pytest.mark.parametrize("workload,name,per_call", [
    ("corpus16k.b128", "host_syncs_per_step.batch", 17),
    ("file16k.linear", "host_syncs_per_call.file", 12),
])
def test_the_tool_counts_the_profiled_calls(workload, name, per_call):
    import importlib

    import torch

    from portbench.tests.small import SEED, SMALL
    from speedy_tpu_torch import trace

    files = run.cell_files(ROOT, BENCH, workload)
    traffic = dict(files["traffic"], **SMALL[workload])
    module = importlib.import_module(f"portbench.entries.{files['entry']}")
    entry = module.Entry(files["config"], traffic, SEED, torch.device("cpu"))
    entry.warm_up(0.1)
    events, syncs, sync_bytes, nxt = program_spans._profile(entry, 0, 2, trace)
    assert nxt == 3
    assert sum(syncs.values()) == 2 * per_call  # the untimed call(0) is left out
    assert set(sync_bytes) == set(syncs) and all(v > 0 for v in sync_bytes.values())
    prog = program_spans.reduce(events)
    assert prog["sync_spans"] == syncs  # one span a counted transfer
    assert program_spans.readings(prog, syncs, 2, entry.unit)[name] == per_call
    assert profiling.reduce.__name__ == "reduce"  # the harness's, put back
