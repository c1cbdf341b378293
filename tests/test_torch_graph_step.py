"""The batch engine's CUDA graphs of its op chains (parallel/graphs.py).

On the CPU an engine never captures, its steps equal
batched_nonlinear_speedup's bitwise, and trace.GRAPHS stays empty. The
run_chain= hooks, the engine's one-key policy and StepGraphs' own rules
(what it captures, copies, counts and refuses) are held here on the CPU,
StepGraphs with stand-ins for torch.cuda's graph objects; with a stand-in
graph whose replay reruns the chain on its static tensors, the graphed
step equals the eager one bitwise.

The tests marked cuda need a card and skip without one. tests/conftest.py
imports JAX, which the card's machine lacks, so there they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_step.py

and hold the graphed step to the eager one, bitwise, over steps with new
gains and new inputs.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speedy_tpu_torch import SpeedupEngine, SpeedyConfig, held, trace
from speedy_tpu_torch.ops import kernels, speed, wsola_fast
from speedy_tpu_torch.parallel import batch, graphs

SR = 16000
RATE, NL, FB, CAP = 3.5, 1.0, 0.1, 1.33
CHAINS = ("tension", "law", "grid")


def _inputs(B, L, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / SR
    tone = np.sin(2 * np.pi * 150 * t) * (1 + np.sin(2 * np.pi * 4 * t))
    xs = 0.3 * tone + 0.05 * rng.standard_normal((B, L))
    gain = rng.uniform(0.5, 1.0, B)
    return (torch.as_tensor(xs.astype(np.float32), device=device),
            torch.as_tensor(gain.astype(np.float32), device=device))


def _engine(device="cpu"):
    return SpeedupEngine(SpeedyConfig(SR), RATE, NL, FB, capacity_factor=CAP).to(device)


def _eager(xs, lengths, gain):
    return batch.batched_nonlinear_speedup(
        xs, lengths, SpeedyConfig(SR), RATE, NL, FB, gain=gain, capacity_factor=CAP)


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def test_an_engine_on_the_cpu_captures_nothing_and_equals_the_eager_step():
    B, L = 2, 2 * SR
    engine = _engine()
    lengths = torch.tensor([L, L - 5000], dtype=torch.int32)
    trace.reset()
    for seed in range(3):
        xs, gain = _inputs(B, L, seed)
        assert _equal(engine(xs, lengths, gain), _eager(xs, lengths, gain))
    assert trace.GRAPHS == {} and not engine._step_graphs


@pytest.mark.parametrize("name", ["analysis_energy_lsd", "pitch_ssd"])
def test_the_eager_step_calls_the_kernels_with_their_arguments_alone(name, monkeypatch):
    # chip_smoke.py's recorded_call stands in for a kernel with a wrapper
    # that takes positional arguments only; the graphed step calls the
    # kernels as the eager one does.
    orig, calls = getattr(kernels, name), []

    def positional(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(kernels, name, positional)
    B, L = 2, SR
    xs, gain = _inputs(B, L, 5)
    _eager(xs, torch.full((B,), L, dtype=torch.int32), gain)
    assert len(calls) == 1


def test_reset_zeroes_the_graph_counts():
    trace.GRAPHS["tension:replay"] = 3
    trace.reset()
    assert trace.GRAPHS == {}


def _recording(calls):
    def run_chain(fn, *inputs, static=()):
        calls.append((inputs, static))
        return fn(*inputs)
    return run_chain


def test_the_law_runs_through_run_chain_unchanged():
    tension = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (2, 300)),
                              dtype=torch.float32)
    calls = []
    got = speed.speed_from_tension_parallel(tension, RATE, FB, NL,
                                            run_chain=_recording(calls))
    assert torch.equal(got, speed.speed_from_tension_parallel(tension, RATE, FB, NL))
    (inputs, static), = calls
    assert inputs[0] is tension and static == (RATE, FB, NL, 8)


def test_the_time_map_runs_through_run_chain_unchanged():
    B, L = 2, 2 * SR
    cfg = SpeedyConfig(SR)
    xs, gain = _inputs(B, L, 4)
    lengths = torch.tensor([L, L - 3000], dtype=torch.int32)
    tables = batch.device_tables(cfg, "cpu")
    T = cfg.num_frames(L, integer_step=True)
    tension = batch.batched_analysis(xs, cfg, T, gain, tables)
    speeds = speed.speed_from_tension_parallel(tension, RATE, FB, NL)
    speeds = torch.nn.functional.pad(speeds, (0, T - speeds.shape[1]), value=RATE)
    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    hop = wsola_fast.default_hop(cfg)
    capacity = batch.grid_output_capacity(cfg, L, RATE, CAP)
    corr = tuple(tables[k] for k in ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band"))
    args = (xs, lengths, speeds, minp, maxp, cfg.frame_step_int, hop, capacity,
            capacity // hop + 1, tables["cola"], corr)
    kw = dict(max_speed_plan=batch._plan_max_speed(RATE, NL), gain=gain)
    calls = []
    got = wsola_fast.wsola_grid_batch(*args, **kw, run_chain=_recording(calls))
    assert _equal(got, wsola_fast.wsola_grid_batch(*args, **kw))
    (inputs, static), = calls
    assert inputs[0] is lengths and inputs[1] is speeds
    assert static[-1] == torch.float32


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Stream:
    def wait_stream(self, other):
        pass


class _Rerun:
    """A stand-in graph whose replay reruns the chain on its static inputs
    into its static outputs, as a CUDA graph's replay does."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        for out, new in zip(graphs._tensors(self.outputs), graphs._tensors(self.fn(*self.inputs))):
            out.copy_(new)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """StepGraphs on the CPU, with torch.cuda's graph, stream and device
    objects replaced by stand-ins that run the block as it is."""
    null = lambda *a, **k: contextlib.nullcontext()
    for name, value in (("graph_pool_handle", lambda: None), ("Stream", lambda d: _Stream()),
                        ("CUDAGraph", _Graph), ("graph", null), ("device", null),
                        ("stream", null), ("current_stream", lambda d=None: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    trace.reset()
    return graphs.StepGraphs("cpu")


@pytest.fixture
def rerun_graphs(cpu_graphs, monkeypatch):
    """cpu_graphs whose chains replay by rerunning fn on their static tensors."""
    capture = graphs.StepGraphs._capture

    def rerun(self, name, fn, inputs, static):
        chain = capture(self, name, fn, inputs, static)
        return chain._replace(graph=_Rerun(fn, chain.inputs, chain.outputs))

    monkeypatch.setattr(graphs.StepGraphs, "_capture", rerun)
    return cpu_graphs


def test_a_chain_is_captured_once_then_replayed(cpu_graphs):
    calls = []

    def fn(x, y):
        calls.append((x, y))
        return x + y, x * y

    x, y = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([4.0, 5.0, 6.0])
    out = cpu_graphs.run("c", fn, x, y, static=(1,))
    # One eager run on the capture stream, one under the capture, both on
    # static clones of the inputs.
    assert len(calls) == 2 and calls[1][0] is not x and calls[1][1] is not y
    chain = cpu_graphs.chains["c"]
    assert torch.equal(out[0], torch.tensor([5.0, 7.0, 9.0])) and out is chain.outputs
    x2, y2 = torch.tensor([7.0, 8.0, 9.0]), torch.tensor([0.0, 1.0, 2.0])
    again = cpu_graphs.run("c", fn, x2, y2, static=(1,))
    assert len(calls) == 2 and again is out
    assert torch.equal(chain.inputs[0], x2) and torch.equal(chain.inputs[1], y2)
    assert chain.graph.replays == 2
    assert trace.GRAPHS == {"c:capture": 1, "c:replay": 2}


def test_a_chain_reads_an_earlier_chains_output_without_a_copy(cpu_graphs):
    first = cpu_graphs.run("a", lambda x: x * 2.0, torch.ones(4))
    seen = []
    cpu_graphs.run("b", lambda t: seen.append(t) or t + 1.0, first)
    assert seen[-1] is first and cpu_graphs.chains["b"].inputs[0] is first


def test_a_chain_refuses_other_python_values(cpu_graphs):
    cpu_graphs.run("c", lambda x: x + 1.0, torch.ones(2), static=(3.5, 8))
    with pytest.raises(ValueError, match="captured with"):
        cpu_graphs.run("c", lambda x: x + 1.0, torch.ones(2), static=(3.0, 8))


def test_chain_binds_the_chains_name(cpu_graphs):
    run_chain = cpu_graphs.chain("law")
    got = run_chain(lambda t: t * 3.0, torch.ones(2), static=(2,))
    assert torch.equal(got, torch.full((2,), 3.0))
    assert list(cpu_graphs.chains) == ["law"] and cpu_graphs.chains["law"].static == (2,)


def test_the_graphed_step_equals_the_eager_step_and_its_results_stay_put(rerun_graphs):
    B, L = 2, 2 * SR
    cfg = SpeedyConfig(SR)
    lengths = torch.tensor([L, L - 4000], dtype=torch.int32)
    xs, _ = _inputs(B, L, 30)
    kept = []
    for step in range(4):
        if step in (1, 3):
            xs, _ = _inputs(B, L, 40 + step)
        gain = _inputs(B, L, 50 + step)[1]
        got = batch.batched_nonlinear_speedup(
            xs, lengths, cfg, RATE, NL, FB, gain=gain, capacity_factor=CAP,
            graphs=rerun_graphs)
        assert _equal(got, _eager(xs, lengths, gain)), step
        kept.append((got, tuple(t.clone() for t in got)))
    for step, (got, copy) in enumerate(kept):
        assert _equal(got, copy), step
    assert trace.GRAPHS == {**{f"{c}:capture": 1 for c in CHAINS},
                            **{f"{c}:replay": 4 for c in CHAINS}}


def test_the_engine_graphs_the_key_of_two_steps_in_a_row(cpu_graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: 7)
    engine = _engine()

    def xs(B):
        return types.SimpleNamespace(is_cuda=True, shape=(B, SR), dtype=torch.float32,
                                     device=torch.device("cpu"), get_device=lambda: 0)

    got = [engine._graphs(xs(B)) for B in (4, 4, 4, 2, 4, 2, 2, 2)]
    assert got[0] is None and got[1] is not None and got[2] is got[1]
    assert got[3] is None and got[4] is None and got[5] is None
    assert got[6] is not None and got[6] is not got[1] and got[7] is got[6]


def test_no_capture_while_a_profiler_records(cpu_graphs):
    with profile(activities=[ProfilerActivity.CPU]):
        got = cpu_graphs.run("c", lambda x: x + 1.0, torch.ones(2))
    assert torch.equal(got, torch.full((2,), 2.0))
    assert not cpu_graphs.chains and trace.GRAPHS == {}


def test_a_chain_holds_the_constants_it_read(cpu_graphs):
    def fn(x):
        return x * held.upload_once("t_graph_const", 0.5, torch.float32, "cpu")

    cpu_graphs.run("c", fn, torch.ones(2))
    kept = cpu_graphs.chains["c"].held
    assert kept and all(h is kept[0] for h in kept) and float(kept[0]) == 0.5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _warm(engine, xs, lengths, gain):
    """A key's eager step and its capture step."""
    for _ in range(2):
        engine(xs, lengths, gain)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_and_stay_put(card):
    B, L = 16, 4 * SR
    engine = _engine(card)
    lengths = torch.tensor([L - 97 * i for i in range(B)], dtype=torch.int32, device=card)
    xs, gain = _inputs(B, L, 0, card)
    _warm(engine, xs, lengths, gain)
    kept = []
    for step in range(4):
        if step in (1, 3):
            xs, _ = _inputs(B, L, 10 + step, card)
        gain = _inputs(B, L, 20 + step, card)[1]
        got = engine(xs, lengths, gain)
        want = _eager(xs, lengths, gain)
        torch.cuda.synchronize()
        assert _equal(got, want), step
        kept.append((got, tuple(t.clone() for t in got)))
    torch.cuda.synchronize()
    for step, (got, copy) in enumerate(kept):
        assert _equal(got, copy), step


@pytest.mark.cuda
def test_a_warm_step_replays_three_graphs_and_syncs_nothing(card):
    B, L = 16, 4 * SR
    engine = _engine(card)
    lengths = torch.full((B,), L, dtype=torch.int32, device=card)
    xs, gain = _inputs(B, L, 1, card)
    trace.reset()
    engine(xs, lengths, gain)
    eager = (dict(trace.LAUNCHES), dict(trace.BODIES))
    engine(xs, lengths, gain)
    assert trace.GRAPHS == {f"{c}:{e}": 1 for c in CHAINS for e in ("capture", "replay")}
    torch.cuda.synchronize()
    trace.reset()
    engine(xs, lengths, gain)
    torch.cuda.synchronize()
    assert trace.SYNCS == {}
    assert trace.GRAPHS == {f"{c}:replay": 1 for c in CHAINS}
    assert (dict(trace.LAUNCHES), dict(trace.BODIES)) == eager


@pytest.mark.cuda
def test_the_graphs_survive_clear_held(card):
    B, L = 16, 4 * SR
    engine = _engine(card)
    lengths = torch.full((B,), L, dtype=torch.int32, device=card)
    xs, gain = _inputs(B, L, 2, card)
    _warm(engine, xs, lengths, gain)
    held.clear_held()
    torch.cuda.empty_cache()
    # Fill what the caching allocator gave back, so a constant the graphs
    # lost would read garbage: the constants are scalars and [64, 64]
    # tables, from its pool of small blocks.
    junk = [torch.full((n,), np.nan, device=card) for n in (1, 64, 4096) for _ in range(512)]
    got = engine(xs, lengths, gain)
    want = _eager(xs, lengths, gain)
    torch.cuda.synchronize()
    del junk
    assert _equal(got, want)


@pytest.mark.cuda
def test_a_second_shape_captures_its_own(card):
    engine = _engine(card)
    steps = []
    for B, L in ((16, 4 * SR), (8, 3 * SR)):
        lengths = torch.full((B,), L, dtype=torch.int32, device=card)
        xs, gain = _inputs(B, L, B, card)
        steps.append((xs, lengths, gain))
        trace.reset()
        _warm(engine, xs, lengths, gain)
        assert trace.GRAPHS == {f"{c}:{e}": 1 for c in CHAINS for e in ("capture", "replay")}
        assert _equal(engine(xs, lengths, gain), _eager(xs, lengths, gain))
    # Back at the first shape: its graphs went with its key, so one eager
    # step, then a capture.
    xs, lengths, gain = steps[0]
    trace.reset()
    assert _equal(engine(xs, lengths, gain), _eager(xs, lengths, gain))
    assert trace.GRAPHS == {}
    assert _equal(engine(xs, lengths, gain), _eager(xs, lengths, gain))
    assert trace.GRAPHS == {f"{c}:{e}": 1 for c in CHAINS for e in ("capture", "replay")}
