"""The port's own instruments (speedy_tpu_torch/trace.py) on the CPU: the
host-blocking transfers of one batch step and of one file counted by site,
cold (nothing held) and warm (the same inputs again), the "speedy:" spans'
names and nesting under a profiler, no span and the same outputs with it
off, the launch counts and their reset, and the kernels' load time.

The counts are the code's: on the CPU every kernel wrapper runs its plain
version, which uploads nothing through trace.upload, so a batch step
counts what a step on the card counts. The file's sequential law is the
one exception: its plain loop builds the law's five scalars
(ops/speed.py::_law), which the law kernel on the card takes as
arguments, so a file on the card counts five law_scalars fewer.

Every site of BATCH_SYNCS, FILE_SYNCS and LINEAR_SYNCS is reached that
many times a call; a constant held by held.upload_once counts in SYNCS the
first time (a cold call) and not after that (a hit). Within one cold call
the two LPFs share α (and in the file their length in chunks, so their
tables), and the law's kMinimumSpeed and frame duration are both 0.01, so
the second of each is already a hit. Each pinned test starts from
held.clear_held(), so the order the tests run in moves no count.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speedy_tpu_torch import SpeedupEngine, SpeedyConfig, held, trace
from speedy_tpu_torch.ops import _build, kernels
from speedy_tpu_torch.pipeline import linear_time_scale, nonlinear_speedup

SR = 16000
B, L = 2, 2 * SR
FILE_LEN = 3 * SR

BATCH_SYNCS = {"lpf_tables": 8, "lpf_alpha": 2, "law_scalars": 5, "rg": 1, "frame_step": 1}
FILE_SYNCS = {
    "input": 1, "frame_starts": 1, "preemphasis_coef": 1, "dft_tables": 3, "eps": 1,
    "lpf_tables": 8, "lpf_alpha": 2, "law_scalars": 5, "speeds_min": 1,
    "input_length": 1, "cola": 1, "pitch_tables": 4, "frame_step": 1,
    "valid_length": 1, "out": 1, "tension": 1, "speeds": 1,
}
LINEAR_SYNCS = {
    "input": 1, "speed": 1, "input_length": 1, "cola": 1, "pitch_tables": 4,
    "frame_step": 1, "valid_length": 1, "out": 1, "speeds": 1,
}
# The sites of held constants: a warm call makes no sync there.
HELD_SITES = ("lpf_tables", "lpf_alpha", "law_scalars", "rg", "frame_step")
# A cold call's hits: the second LPF's α and the second 0.01 of the law;
# in the file the two LPFs are one count of chunks long, so their tables too.
BATCH_COLD_HITS = {"lpf_alpha": 1, "law_scalars": 1}
FILE_COLD_HITS = {"lpf_tables": 4, "lpf_alpha": 1, "law_scalars": 1}
# Four bytes a float32 scalar.
SCALAR_SITES = ("lpf_alpha", "law_scalars", "rg", "frame_step", "preemphasis_coef", "eps",
                "speeds_min", "input_length", "valid_length", "speed")


@pytest.fixture(scope="module")
def engine():
    return SpeedupEngine(SpeedyConfig(SR), 3.5, 1.0, 0.1, capacity_factor=1.33)


@pytest.fixture(scope="module")
def batch_inputs():
    rng = np.random.default_rng(3)
    xs = torch.from_numpy((0.1 * rng.standard_normal((B, L))).astype(np.float32))
    return xs, torch.full((B,), L, dtype=torch.int32), torch.tensor([0.6, 0.9])


@pytest.fixture(scope="module")
def wav():
    rng = np.random.default_rng(4)
    t = np.arange(FILE_LEN) / SR
    tone = np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    return (3000 * tone + 300 * rng.standard_normal(FILE_LEN)).astype(np.int16)


def _file(wav, nl=1.0):
    return nonlinear_speedup(wav, SpeedyConfig(SR), 3.5, nl, 0.1, engine="grid",
                             device="cpu")


def _scalar_bytes(syncs):
    return {k: 4 * n for k, n in syncs.items() if k in SCALAR_SITES}


def _less(counts, hits):
    """counts less hits, by site, dropping the sites that reach 0."""
    out = {k: n - hits.get(k, 0) for k, n in counts.items()}
    return {k: n for k, n in out.items() if n}


def _warm(pinned):
    """A warm call: pinned's syncs but those of held constants, which hit."""
    return {k: n for k, n in pinned.items() if k not in HELD_SITES}


def test_batch_step_counts_its_syncs_by_site(engine, batch_inputs):
    held.clear_held()
    trace.reset()
    res = engine(*batch_inputs)
    assert trace.SYNCS == _less(BATCH_SYNCS, BATCH_COLD_HITS)
    assert set(trace.SYNC_BYTES) == set(BATCH_SYNCS)
    for site, nbytes in _scalar_bytes(trace.SYNCS).items():
        assert trace.SYNC_BYTES[site] == nbytes
    # Two filters of other lengths, each four power tables in float32.
    assert trace.SYNC_BYTES["lpf_tables"] % 8 == 0 and trace.SYNC_BYTES["lpf_tables"] > 0
    assert res.output.shape[0] == B
    assert not any(trace.LAUNCHES.values())  # CPU tensors: plain versions
    trace.reset()
    engine(*batch_inputs)
    assert trace.SYNCS == {}
    assert trace.SYNC_BYTES == {}


def test_file_counts_its_syncs_and_read_backs_by_site(wav):
    held.clear_held()
    trace.reset()
    res = _file(wav)
    assert trace.SYNCS == _less(FILE_SYNCS, FILE_COLD_HITS)
    for site, nbytes in _scalar_bytes(trace.SYNCS).items():
        assert trace.SYNC_BYTES[site] == nbytes
    assert trace.SYNC_BYTES["input"] == 4 * FILE_LEN
    assert trace.SYNC_BYTES["out"] == 4 * len(res.output)
    assert trace.SYNC_BYTES["tension"] == 4 * len(res.tension)
    assert trace.SYNC_BYTES["speeds"] == 4 * len(res.speeds)
    trace.reset()
    again = _file(wav)
    assert trace.SYNCS == _warm(FILE_SYNCS)
    assert np.array_equal(again.output, res.output)


def test_linear_file_counts_fewer_and_reads_no_tension(wav):
    held.clear_held()
    trace.reset()
    res = _file(wav, nl=0.0)
    assert trace.SYNCS == LINEAR_SYNCS
    assert res.tension.dtype == np.float32 and res.tension.shape == (0,)
    trace.reset()
    again = linear_time_scale(wav, SpeedyConfig(SR), 3.5, engine="grid", device="cpu")
    assert trace.SYNCS == _warm(LINEAR_SYNCS)
    assert np.array_equal(again.output, res.output)


def _span_tree(prof, tmp_path):
    """(depth, name) of every speedy: range in start order, depth counted
    in speedy: ranges."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(trace.PREFIX))
    out, stack = [], []
    for ts, neg_dur, name in ranges:
        while stack and stack[-1] <= ts:
            stack.pop()
        out.append((len(stack), name[len(trace.PREFIX):]))
        stack.append(ts - neg_dur)
    return out


def _collapse(tree):
    """Runs of one (depth, name) as (depth, name, count)."""
    out = []
    for item in tree:
        if out and out[-1][:2] == item:
            out[-1] = (*item, out[-1][2] + 1)
        else:
            out.append((*item, 1))
    return out


def test_spans_name_the_layers_and_nest_the_syncs(engine, batch_inputs, wav, tmp_path):
    held.clear_held()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine(*batch_inputs)
    # Cold: the second LPF's α is held already (the tables differ in length).
    lpf = [(2, "sync:lpf_tables", 4), (2, "sync:lpf_alpha", 1)]
    assert _collapse(_span_tree(prof, tmp_path)) == [
        (0, "batch", 1),
        (1, "analysis", 1), *lpf, (2, "sync:lpf_tables", 4),
        (1, "speed_law", 1), (2, "sync:law_scalars", 4),
        (1, "sync:rg", 1),
        (1, "grid_engine", 1), (2, "sync:frame_step", 1),
    ]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine(*batch_inputs)
    assert _collapse(_span_tree(prof, tmp_path)) == [
        (0, "batch", 1), (1, "analysis", 1), (1, "speed_law", 1), (1, "grid_engine", 1),
    ]
    held.clear_held()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _file(wav)
    assert _collapse(_span_tree(prof, tmp_path)) == [
        (0, "file", 1),
        (1, "input", 1), (2, "sync:input", 1),
        (1, "analysis", 1), (2, "sync:frame_starts", 1), (2, "sync:preemphasis_coef", 1),
        (2, "sync:dft_tables", 3), (2, "sync:eps", 1), *lpf,
        (1, "speed_law", 1), (2, "sync:law_scalars", 4),
        (1, "sync:speeds_min", 1),
        (1, "grid_engine", 1), (2, "sync:input_length", 1), (2, "sync:cola", 1),
        (2, "sync:pitch_tables", 4), (2, "sync:frame_step", 1),
        (1, "read-back", 1), (2, "sync:valid_length", 1), (2, "sync:out", 1),
        (2, "sync:tension", 1), (2, "sync:speeds", 1),
    ]
    held.clear_held()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _file(wav, nl=0.0)
    assert _collapse(_span_tree(prof, tmp_path))[:4] == [
        (0, "file", 1), (1, "input", 1), (2, "sync:input", 1), (1, "sync:speed", 1)]


def test_no_profiler_no_record_function(engine, batch_inputs, wav, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.layer("batch") is trace.layer("file")  # one shared null context
    engine(*batch_inputs)
    _file(wav)
    _file(wav, nl=0.0)


def test_outputs_with_the_profiler_on_equal_those_with_it_off(engine, batch_inputs, wav):
    off_b, off_f, off_l = engine(*batch_inputs), _file(wav), _file(wav, nl=0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        on_b, on_f, on_l = engine(*batch_inputs), _file(wav), _file(wav, nl=0.0)
    for a, b in zip(off_b, on_b):
        assert torch.equal(a, b)
    for off, on in ((off_f, on_f), (off_l, on_l)):
        for a, b in zip(off[:3], on[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert off.achieved_rate == on.achieved_rate


def test_launches_are_the_trace_modules_dict(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda: {"pitch_ssd": lambda *args: 0})
    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: 0)
    trace.reset()
    kernels._launch("pitch_ssd", torch.device("cuda", 0), 1, 2)
    assert trace.LAUNCHES == {**dict.fromkeys(trace.LAUNCHES, 0), "pitch_ssd": 1}
    trace.BODIES["pitch_ssd:x"] = 1
    trace.SYNCS["x"] = 1
    trace.SYNC_BYTES["x"] = 4
    trace.GRAPHS["law:replay"] = 1
    trace.reset()
    assert not any(trace.LAUNCHES.values())
    assert trace.BODIES == trace.SYNCS == trace.SYNC_BYTES == trace.GRAPHS == {}


def test_upload_counts_host_data_and_not_a_tensor_already_there():
    trace.reset()
    host = np.arange(6, dtype=np.float32)
    t = trace.upload("a", host, device="cpu")
    assert torch.equal(t, torch.as_tensor(host))
    s = trace.upload("b", 0.97, dtype=torch.float32, device=torch.device("cpu"))
    assert s.dtype == torch.float32 and s.item() == torch.tensor(0.97).item()
    assert trace.upload("c", t, dtype=torch.float32, device="cpu") is t
    assert trace.upload("c", t) is t
    assert trace.SYNCS == {"a": 1, "b": 1}
    assert trace.SYNC_BYTES == {"a": 24, "b": 4}
    assert torch.equal(trace.read_back("d", t[:2]), t[:2])
    assert trace.read_back("e", t[5], int) == 5
    assert trace.SYNCS["d"] == 1 and trace.SYNC_BYTES["d"] == 8
    assert trace.SYNC_BYTES["e"] == 4


def test_a_warm_step_equals_a_cold_one_and_leaves_the_held_constants(engine, batch_inputs):
    held.clear_held()
    cold = engine(*batch_inputs)
    kept = dict(held._held)
    assert len(kept) == sum(BATCH_SYNCS.values()) - sum(BATCH_COLD_HITS.values())
    before = {k: v.clone() for k, v in kept.items()}
    trace.reset()
    warm = engine(*batch_inputs)
    assert trace.SYNCS == {}
    for name in ("output", "valid_length", "tension", "speeds"):
        a, b = getattr(cold, name), getattr(warm, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert held._held.keys() == kept.keys()
    for k, v in held._held.items():
        assert v is kept[k] and torch.equal(v, before[k]) and v.dtype == before[k].dtype


@pytest.mark.parametrize("built_before", [False, True])
def test_load_records_its_seconds_and_whether_it_built(built_before, tmp_path, monkeypatch):
    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    if built_before:
        _build.library_path().parent.mkdir(parents=True)
        _build.library_path().touch()
    monkeypatch.setattr(_build, "_library", Lib)
    monkeypatch.setattr(trace, "LOAD_S", None)
    monkeypatch.setattr(trace, "LOAD_BUILT", None)
    _build.load.cache_clear()
    try:
        table = _build.load()
    finally:
        _build.load.cache_clear()
    assert set(table) == set(trace.LAUNCHES)
    assert trace.LOAD_S is not None and trace.LOAD_S >= 0.0
    assert trace.LOAD_BUILT is (not built_before)
