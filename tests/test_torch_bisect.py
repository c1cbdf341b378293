"""The PyTorch port's bisection probes (kernels 10, 11 and 14) against the
JAX experiments they port, on the CPU, where every wrapper takes its plain
version.

experiments/gather_bisect.py and synth_bisect.py time B = 128 utterances
of 10 s at module level, so they are not imported: their files are parsed
with ast, the top-level statements before the first timeit(...) call are
run into a fresh module, and gather_variant and make_fused are called from
it. experiments/bisect_kernel.py runs its kernel at module level from
sys.argv (`which R w_rows`), so it is run with runpy under a patched
sys.argv and its globals (out, nvb, bases, q8k, x2) are read back. Every
pallas_call runs in interpret mode, and nothing in experiments/ changes.

Interpret mode leaves the blocks the TPU kernels skip as NaN, where the
port writes zeros, so the experiments are compared on live blocks only:
bitwise for the copy, select and shift stages, within 1e-6 for the
interpolation and overlap-add, which round in float32 in the same order.
"""

import ast
import json
import pathlib
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from speedy_tpu_torch import trace
from speedy_tpu_torch.experiments import bisect_kernel, gather_bisect, synth_bisect
from speedy_tpu_torch.ops import kernels, wsola_fast

EXPERIMENTS = pathlib.Path(__file__).resolve().parent.parent / "experiments"
B, L, K = 2, 60000, 300  # K = 2 * 128 + 44: the last block is padded
N_VALID = (300, 200)     # utterance 1's third block is dead


def _load_until_timeit(name: str) -> types.ModuleType:
    """experiments/<name>.py's top-level statements before its first
    timeit(...) call, run into a fresh module."""
    path = EXPERIMENTS / f"{name}.py"
    body = []
    for node in ast.parse(path.read_text()).body:
        call = node.value if isinstance(node, ast.Expr) else None
        if isinstance(call, ast.Call) and getattr(call.func, "id", None) == "timeit":
            break
        body.append(node)
    mod = types.ModuleType(f"jax_experiment_{name}")
    mod.__file__ = str(path)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), mod.__dict__)
    return mod


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Every pallas_call in interpret mode (the fixture of
    tests/test_pallas_kernels.py, copied)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.fixture(scope="module")
def jax_gather():
    return _load_until_timeit("gather_bisect")


@pytest.fixture(scope="module")
def jax_synth():
    return _load_until_timeit("synth_bisect")


@pytest.fixture(scope="module")
def case():
    """x [2, 60000] standard normals; starts stepping 150-229 samples (a
    block of 128 spans under 30,000, inside either span plan), so every
    row's window lies in x; fractions uniform in [0, 1)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, L)).astype(np.float32)
    starts = np.cumsum(rng.integers(150, 230, (B, K)), axis=1).astype(np.int32)
    af = rng.uniform(0, 1, (B, K)).astype(np.float32)
    return x, starts, af, np.array(N_VALID, np.int32)


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _live_rows(n_valid, R=128):
    """[B, K] bool: the rows of live blocks."""
    nvb = -(-np.asarray(n_valid) // R)
    return np.arange(K)[None, :] < nvb[:, None] * R


def _live_blocks(n_valid, NB, R=128):
    return np.arange(NB)[None, :] < (-(-np.asarray(n_valid) // R))[:, None]


def test_the_experiments_load_with_their_constants(jax_gather, jax_synth):
    assert (jax_gather.width, jax_gather.R, jax_gather.w_span) == (321, 128, 122880)
    p = gather_bisect.plan()
    assert (p["hop"], p["K"], p["Lp"], p["maxp"]) == (jax_gather.hop, jax_gather.K,
                                                      jax_gather.Lp_sig, jax_gather.pad_front)
    assert gather_bisect.span_plan(p, 6.0) == jax_gather.w_span
    assert (synth_bisect.plan()["Lp"], jax_synth.Hs) == (jax_synth.Lp_sig, p["hop"])
    starts, n_valid = gather_bisect.starts_n_valid(p, "cpu")
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jax_gather.starts))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(jax_gather.n_valid))
    assert kernels.bisect_w_rows(122880, 4) == 984 and kernels.bisect_w_rows(81920, 4) == 664


# ---------------------------------------------------------------------------
# Kernel 10: gather_bisect
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", kernels.GATHER_BISECT_STAGES)
def test_gather_bisect_matches_the_experiment(interpret_pallas, jax_gather, case, stage):
    x, starts, _, n_valid = case
    want = np.asarray(jax_gather.gather_variant(x, starts, n_valid, stage))
    got = kernels.gather_bisect(*_torch(x, starts, n_valid), stage, width=321,
                                rows_per_block=128, w_span=jax_gather.w_span).numpy()
    live = _live_rows(n_valid)
    assert got.shape == want.shape == (B, K, 321)
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()  # the dead block is zero


def test_gather_bisect_full_is_the_row_gather(case):
    """full is kernel 5's function: x[b, s : s + width] on every row below
    n_valid, and the rest of a live block from its starts too."""
    x, starts, _, n_valid = _torch(*case)
    got = kernels.gather_bisect(x, starts, n_valid, "full", width=321, rows_per_block=128,
                                w_span=122880)
    rows = kernels.gather_rows_reference(x, starts, 321)
    below = torch.arange(K)[None, :] < n_valid[:, None]
    live = torch.as_tensor(_live_rows(case[3]))
    assert torch.equal(got[below], kernels.gather_rows_reference(x, starts, 321, n_valid)[below])
    assert torch.equal(got[live], rows[live]) and not got[~live].any()


def test_gather_bisect_late_span_reads_the_next_utterance(case):
    """dma copies R * nt span rows from the block's base: block 2 of
    utterance 0 runs past L and reads the padding, then utterance 1."""
    x, starts, _, n_valid = _torch(*case)
    got = kernels.gather_bisect(x, starts, n_valid, "dma", width=321, rows_per_block=128,
                                w_span=122880)
    _, first, _ = kernels.bisect_span_geometry(starts, n_valid, 128, L)
    assert kernels.padded_len(L) == 60416
    flat = torch.cat([torch.cat([x, x.new_zeros(B, 60416 - L)], 1).reshape(-1),
                      x.new_zeros(992 * 128)])
    i = torch.arange(128 * 4).reshape(128, 4)[:, :3].reshape(-1)  # rows r*nt + t, t < 3
    rows = flat[int(first[0, 2]):][: 512 * 128].reshape(512, 128)[i].reshape(128, 384)
    assert int(first[0, 2]) + 512 * 128 > 60416  # past utterance 0's padded end
    assert torch.equal(got[0, 256:], rows[: K - 256, :321])


# ---------------------------------------------------------------------------
# Kernel 11: synth_bisect
# ---------------------------------------------------------------------------

SYNTH_CASES = [(stage, 6.0) for stage in kernels.SYNTH_BISECT_STAGES] + [("full", 4.0)]


@pytest.mark.parametrize("stage,max_speed", SYNTH_CASES,
                         ids=[f"{s}-{m}" for s, m in SYNTH_CASES])
def test_synth_bisect_matches_the_experiment(interpret_pallas, jax_synth, case, stage,
                                             max_speed):
    x, starts, af, n_valid = case
    want = np.asarray(jax_synth.make_fused(stage, max_speed)(x, starts, af, n_valid))
    w_span = {6.0: 122880, 4.0: 81920}[max_speed]
    got = kernels.synth_bisect(*_torch(x, starts, af, n_valid), stage, hop=160,
                               rows_per_block=128, w_span=w_span).numpy()
    live = _live_blocks(n_valid, 3)
    assert got.shape == want.shape == (B, 3, 256, 128)
    if stage in ("dma", "onehot", "barrel"):
        np.testing.assert_array_equal(got[live], want[live])
    else:
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-6)
    assert not got[~live].any()  # the dead block is zero


def test_synth_bisect_full_is_kernel_3(case):
    """full on lanes below hop is kernel 3's slot (gain 1, no mask) on
    every row of a live block: slot k = raw_w[k][j] + raw_w[k-1][hop + j],
    slot 0 unwindowed; its row 0 of block 1 takes block 0's last row."""
    x, starts, af, n_valid = _torch(*case)
    got = kernels.synth_bisect(x, starts, af, n_valid, "full", hop=160, rows_per_block=128,
                               w_span=122880)
    win = torch.as_tensor(wsola_fast._cola_hann(320))
    ref = kernels.gather_synth_reference(
        x, starts, af, win, torch.ones(B), torch.full((B,), K * 160, dtype=torch.int32),
        160, K * 160).reshape(B, K, 160)
    slots = synth_bisect.slots(got, K)[..., :160]
    live = torch.as_tensor(_live_rows(case[3]))
    assert float((slots - ref).abs()[live].max()) <= 1e-6


# ---------------------------------------------------------------------------
# Kernel 14: bisect_kernel
# ---------------------------------------------------------------------------

SPAN_CASES = [(mode, R) for R in (8, 16) for mode in ("dma", "dot", "full", "zero")]


@pytest.mark.parametrize("mode,R", SPAN_CASES, ids=[f"{m}-R{r}" for m, r in SPAN_CASES])
def test_bisect_span_rows_matches_the_experiment(interpret_pallas, monkeypatch, mode, R):
    """The experiment's own inputs at w_rows = 64: its random q8k make
    neighbouring rows shift by different amounts, so full is no single
    shift."""
    monkeypatch.setattr(sys, "argv", ["bisect_kernel.py", mode, str(R), "64"])
    g = runpy.run_path(str(EXPERIMENTS / "bisect_kernel.py"))
    want = np.asarray(g["out"])
    nvb, bases, q8k, x2 = bisect_kernel.inputs(R, 64, "cpu")
    np.testing.assert_array_equal(q8k.numpy(), np.asarray(g["q8k"])[..., 0])
    np.testing.assert_array_equal(x2.numpy(), np.asarray(g["x2"]))
    np.testing.assert_array_equal(bases.numpy(), np.asarray(g["bases"]))
    got = kernels.bisect_span_rows(nvb, bases, q8k, x2, mode, rows_per_block=R, w_rows=64,
                                   nt=4, length_rows=1600).numpy()
    live = _live_blocks([3 * R, 2 * R], 3, R) if mode != "zero" else np.ones((2, 3), bool)
    assert got.shape == want.shape == (2, 3, R * 4, 128)
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()


def test_bisect_span_rows_full_is_no_single_shift():
    """Each row's own bits, read at every step: the walk moves some lanes
    across two rows, which no per-row shift by q8k & 127 does."""
    nvb, bases, q8k, x2 = bisect_kernel.inputs(8, 64, "cpu")
    kw = dict(rows_per_block=8, w_rows=64, nt=4, length_rows=1600)
    full = kernels.bisect_span_rows(nvb, bases, q8k, x2, "full", **kw)
    dot = kernels.bisect_span_rows(nvb, bases, q8k, x2, "dot", **kw)
    sh = (q8k & 127).long()[..., None] + torch.arange(128)
    nxt = torch.roll(dot, -1, dims=2)
    one_shift = torch.where(sh < 128, dot.gather(3, sh.clamp(max=127)),
                            nxt.gather(3, (sh - 128).clamp(min=0)))
    assert not torch.equal(full[:, :2], one_shift[:, :2])


def test_bisect_span_rows_dma_needs_the_rows():
    nvb, bases, q8k, x2 = bisect_kernel.inputs(32, 64, "cpu")
    with pytest.raises(ValueError, match="span rows"):
        kernels.bisect_span_rows(nvb, bases, q8k, x2, "dma", rows_per_block=32, w_rows=64,
                                 nt=4, length_rows=1600)


# ---------------------------------------------------------------------------
# Kernel 14's walk from two rows' bits (csrc/barrel.cuh)
# ---------------------------------------------------------------------------


def _high_bit(x):
    """The position of x's highest set bit, x in [1, 128)."""
    return sum((x >= (1 << b)).astype(int) for b in range(1, 7))


def _walk_steps(bits, next_bits, lane):
    """barrel_source step by step, on row i and next(i) alone: (source
    lane, source on next(i))."""
    lane, cur = np.array(lane), np.array(bits)
    wrapped = np.zeros(lane.shape, bool)
    for k in range(6, -1, -1):
        lane = lane + (cur & (1 << k))
        past = lane >= 128
        lane = np.where(past, lane - 128, lane)
        cur = np.where(past, next_bits, cur)
        wrapped |= past
    return lane, wrapped


def _walk(bits, next_bits, lane):
    """barrel_source_two_rows (csrc/barrel.cuh): the walk in closed form.
    It wraps iff lane + s >= 128 (s = bits & 127), onto (lane & below) +
    (next_bits & below), below = 2^p - 1 for the highest bit p at which
    lane and s agree (0 where they agree nowhere)."""
    s = bits & 127
    agree = ~(s ^ lane) & 127
    below = np.where(agree > 0, (1 << _high_bit(np.maximum(agree, 1))) - 1, 0)
    wrapped = lane + s >= 128
    return np.where(wrapped, (lane & below) + (next_bits & below), lane + s), wrapped


def test_two_row_walk_closed_form_matches_the_steps():
    """Every low 7 bits of row i and of next(i), every lane: the closed
    form lands where the 7 steps do, and a walk wraps at most once."""
    s, n, lane = (a.ravel() for a in np.meshgrid(np.arange(128), np.arange(128),
                                                 np.arange(128), indexing="ij"))
    want = _walk_steps(s, n, lane)
    got = _walk(s, n, lane)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0].min() >= 0 and want[0].max() < 128


def _walk_case(name):
    """q8k [tot] for one block of kernel 14's slab, by case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "probe":  # the probe's picks: R = 128, w_rows = 1,024
        return rng.integers(0, 1023, 512)
    if name == "negative":
        return rng.integers(-5000, 0, 512)
    if name == "past_w_rows":
        return rng.integers(1024, 1 << 20, 512)
    if name == "low_bits_set":  # q & 127 == 127, beside neighbours of other bits
        q = rng.integers(-1 << 12, 1 << 12, 512) | 127
        q[1::3] = rng.integers(-1 << 12, 1 << 12, q[1::3].shape)
        return q
    if name == "int32_ends":
        return rng.choice(np.array([-(1 << 31), -(1 << 31) + 127, -1, 0, 127, 128,
                                    (1 << 31) - 129, (1 << 31) - 1]), 512)
    R = int(name[len("last_row_R"):])  # chip_smoke.check_bisect_edges' picks at R = 8, 12
    q = rng.integers(-3, 43, R * 4)
    q[-1] = 127  # the last row wraps onto row 0 from every lane but 0
    return q


WALK_CASES = ["probe", "negative", "past_w_rows", "low_bits_set", "int32_ends",
              "last_row_R8", "last_row_R12"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_two_row_walk_matches_the_barrel(name):
    """Kernel 14's shift as the kernel makes it, each output (i, l) from
    q8k[i] and q8k[next(i)] alone (next(tot - 1) = 0), against _barrel's
    7 roll-and-select passes over a slab of distinct values."""
    q = _walk_case(name).astype(np.int32)
    tot = q.size
    slab = torch.arange(tot * 128, dtype=torch.float32).reshape(tot, 128)
    want = kernels._barrel(slab, torch.as_tensor(q), 1).numpy()
    i, lane = np.meshgrid(np.arange(tot), np.arange(128), indexing="ij")
    nxt = (i + 1) % tot
    src, wrapped = _walk(q[i].astype(np.int64), q[nxt].astype(np.int64), lane)
    np.testing.assert_array_equal(slab.numpy()[np.where(wrapped, nxt, i), src], want)
    if name.startswith("last_row"):
        assert wrapped[-1, 1:].all()


# ---------------------------------------------------------------------------
# The entry points, on the CPU at a small batch
# ---------------------------------------------------------------------------


def test_gather_bisect_entry_point(monkeypatch):
    monkeypatch.setattr(gather_bisect, "BATCH", 2)
    rows = gather_bisect.check("cpu")
    assert [r["stage"] for r in rows] == list(kernels.GATHER_BISECT_STAGES)
    for r in rows:
        assert (r["B"], r["K"], r["launches"], r["max_abs_err"], r["ms"]) == (2, 1009, 0, 0.0,
                                                                             None)
        assert r["out_words"] == 2 * 1009 * 321 and r["read_words"] > 2 * 1009
    # dma copies whole slab rows; full reads each live row's window once
    assert rows[2]["read_words"] < rows[0]["read_words"]


def test_synth_bisect_entry_point(monkeypatch, capsys):
    monkeypatch.setattr(gather_bisect, "BATCH", 2)
    monkeypatch.setattr(synth_bisect, "BATCH", 2)
    assert synth_bisect.main(["--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["stage"], r["max_speed"]) for r in rows] == list(synth_bisect.CASES)
    assert all(r["max_abs_err"] <= 1e-6 and r["launches"] == 0 for r in rows)
    assert [r["kernel3_max_abs_err"] is None for r in rows] == [True] * 4 + [False] * 2
    assert [r["w_span"] for r in rows] == [122880] * 5 + [81920]


def test_bisect_kernel_entry_point(capsys):
    assert bisect_kernel.main(["full", "8", "64", "--device", "cpu"]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert (row["mode"], row["R"], row["w_rows"], row["max_abs_err"]) == ("full", 8, 64, 0.0)
    rows = bisect_kernel.check("cpu")
    assert [r["mode"] for r in rows] == list(bisect_kernel.MODES)
    assert rows[0]["read_words"] == 2 * 3 * 512  # no copy: q8k only
    assert all(r["increment_ms"] is None for r in rows)


@pytest.mark.parametrize("probe", [gather_bisect, synth_bisect, bisect_kernel],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_bisect_entry_points_default_to_the_card(probe):
    """Without --device a probe asks for the card, and raises where there
    is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs the probes there")
    for run in (lambda: probe.main([]), probe.check):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_bisect_wrappers_check_their_arguments():
    x, s = torch.zeros(1, 4096), torch.zeros(1, 4, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="stage"):
        kernels.gather_bisect(x, s, n, "barrel", width=321, rows_per_block=128, w_span=4096)
    with pytest.raises(ValueError, match="stage"):
        kernels.synth_bisect(x, s, torch.zeros(1, 4), n, "shift", hop=160, rows_per_block=128,
                             w_span=4096)
    with pytest.raises(ValueError, match="rows_per_block"):
        kernels.gather_bisect(x, s, n, "full", width=321, rows_per_block=0, w_span=4096)
    trace.reset()
    kernels.gather_bisect(x, s, n, "full", width=321, rows_per_block=128, w_span=4096)
    assert trace.LAUNCHES == dict.fromkeys(trace.LAUNCHES, 0)
