"""The port's sequential speed law, kernels.speed_law (csrc/speed_law.cu on
the card) and speed.speed_from_tension, on the CPU, where the wrapper runs
its plain version, the loop over frames. The kernel is held bitwise to
that loop on the card by chip_smoke.py.

Tolerances: the loop against speedy_tpu/ops/speed.py's lax.scan on the
same seeded tension within rtol = atol = 1e-6 for speeds (as
test_torch_frontend.py holds it). XLA:CPU contracts the law's
rg + (1 - rg) * t into an FMA, so the two part by an ulp on some frames
and are not bitwise; at 1.0x they are. The durations integrate T such
ulps, so they are held within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speedy_tpu.ops import speed as jspeed

from speedy_tpu_torch import SpeedyConfig, batched_nonlinear_speedup, pipeline, trace
from speedy_tpu_torch.ops import kernels, speed

from torch_port_util import speech_families

RATES = (0.7, 1.0, 3.5)
FEEDBACK = (0.0, 0.1)
NONLINEAR = (0.5, 1.0)


def _tension(B, T, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


def _jax_law(tension, rate, fb, nl, cur0=None, des0=None):
    """speedy_tpu/ops/speed.py:49 vmapped over the batch: (speeds, cur, des)."""
    B = tension.shape[0]
    cur0 = np.zeros(B, np.float32) if cur0 is None else cur0
    des0 = np.zeros(B, np.float32) if des0 is None else des0
    law = jax.vmap(lambda t, c, d: jspeed.speed_from_tension(t, rate, fb, nl, (c, d)))
    speeds, (cur, des) = law(jnp.asarray(tension), jnp.asarray(cur0), jnp.asarray(des0))
    return np.asarray(speeds), np.asarray(cur), np.asarray(des)


# (rate, fb, nl, B, T): every setting at B in (1, 5) and T in (0, 1, 999,
# 6000); then the lengths and batch sizes at the kernel's edges (chunks of
# 16 frames, warps of 8 walkers; the parent's chunks of 64 and blocks of
# 32), below and above 1x with feedback.
LAW_CASES = [(rate, fb, nl, B, T) for rate in RATES for fb in FEEDBACK for nl in NONLINEAR
             for B in (1, 5) for T in (0, 1, 999, 6000)]
LAW_CASES += [(rate, 0.1, 1.0, B, T) for rate in (0.7, 3.5)
              for B, T in ((1, 15), (1, 16), (1, 17), (1, 63), (1, 64), (1, 65), (1, 129),
                           (1, 1000), (7, 17), (9, 33), (31, 65), (33, 129), (33, 1000),
                           (128, 64), (128, 129))]


@pytest.mark.parametrize("rate,fb,nl,B,T", LAW_CASES,
                         ids=["-".join(map(str, case)) for case in LAW_CASES])
def test_speed_law_matches_jax_scan(rate, fb, nl, B, T):
    tension = _tension(B, T)
    speeds, (cur, des) = kernels.speed_law(torch.as_tensor(tension), rate, fb, nl)
    s_j, c_j, d_j = _jax_law(tension, rate, fb, nl)
    assert speeds.shape == (B, T) and cur.shape == des.shape == (B,)
    np.testing.assert_allclose(speeds.numpy(), s_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cur.numpy(), c_j, rtol=1e-6, atol=0)
    np.testing.assert_allclose(des.numpy(), d_j, rtol=1e-6, atol=0)
    if rate == 1.0:
        np.testing.assert_array_equal(speeds.numpy(), s_j)


@pytest.mark.parametrize("rate,fb,nl", [(0.7, 0.1, 1.0), (3.5, 0.1, 0.5), (1.0, 0.0, 1.0)])
def test_wrapper_is_the_plain_loop_on_the_cpu(rate, fb, nl):
    tension = torch.as_tensor(_tension(5, 999))
    init = (torch.full((5,), 0.25), torch.full((5,), 0.5))
    for durations in (None, init):
        got = kernels.speed_law(tension, rate, fb, nl, durations)
        want = kernels.speed_law_reference(tension, rate, fb, nl, durations)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1][0], want[1][0]) and torch.equal(got[1][1], want[1][1])
    assert trace.LAUNCHES["speed_law"] == 0


@pytest.mark.parametrize("rate", [0.7, 3.5])
def test_initial_durations_match_jax(rate):
    rng = np.random.default_rng(8)
    B, T = 5, 999
    tension = _tension(B, T, seed=9)
    cur0 = rng.uniform(0.0, 4.0, B).astype(np.float32)
    des0 = rng.uniform(0.0, 4.0, B).astype(np.float32)
    speeds, (cur, des) = kernels.speed_law(
        torch.as_tensor(tension), rate, 0.1, 1.0, (torch.as_tensor(cur0), torch.as_tensor(des0)))
    s_j, c_j, d_j = _jax_law(tension, rate, 0.1, 1.0, cur0, des0)
    np.testing.assert_allclose(speeds.numpy(), s_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cur.numpy(), c_j, rtol=1e-6, atol=0)
    np.testing.assert_allclose(des.numpy(), d_j, rtol=1e-6, atol=0)
    # The carried excess changes the feedback: not the zero-start result.
    assert not np.allclose(s_j, _jax_law(tension, rate, 0.1, 1.0)[0], atol=1e-3)


def test_initial_durations_with_no_frames_come_back():
    cur0, des0 = torch.tensor([1.5, 2.0]), torch.tensor([1.0, 3.0])
    speeds, (cur, des) = kernels.speed_law(torch.zeros(2, 0), 0.7, 0.1, 1.0, (cur0, des0))
    assert speeds.shape == (2, 0)
    assert torch.equal(cur, cur0) and torch.equal(des, des0)


@pytest.mark.parametrize("case", ["float64", "non-contiguous", "1-D", "durations [B+1]",
                                  "durations float64", "durations non-contiguous"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    t = torch.as_tensor(_tension(4, 64))
    z = torch.zeros(4)
    args = {
        "float64": (t.double(), None),
        "non-contiguous": (t[:, ::2], None),
        "1-D": (t[0], None),
        "durations [B+1]": (t, (torch.zeros(5), z)),
        "durations float64": (t, (z, z.double())),
        "durations non-contiguous": (t, (torch.zeros(8)[::2], z)),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        kernels.speed_law(args[0], 0.7, 0.1, 1.0, args[1])


def test_speed_from_tension_takes_strided_tension_and_durations():
    t = torch.as_tensor(_tension(3, 200))
    init = (torch.full((3,), 0.1), torch.zeros(3))
    got = speed.speed_from_tension(t.t().contiguous().t(), 0.7, 0.1, 1.0, init)
    want = kernels.speed_law_reference(t, 0.7, 0.1, 1.0, init)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0], want[1][0])


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of kernels.speed_law (and runs them)."""
    calls = []
    law = kernels.speed_law

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return law(*args, **kwargs)

    monkeypatch.setattr(kernels, "speed_law", counting)
    return calls


@pytest.mark.parametrize("rate", [0.7, 3.5])
def test_single_path_routes_through_the_kernel_wrapper(counted, rate):
    cfg = SpeedyConfig(16000)
    x = speech_families(16000, 16000, 1, seed=2)[0]
    res = pipeline.nonlinear_speedup(x, cfg, rate, engine="grid", device="cpu")
    assert len(counted) == 1 and counted[0] == (1, len(res.tension))
    pipeline.nonlinear_speedup(x, cfg, rate, engine="grid", device="cpu", reference=True)
    assert len(counted) == 1  # the plain path runs the loop, not the wrapper


@pytest.mark.parametrize("rate,routed", [(0.7, True), (3.5, False)])
def test_batch_path_routes_through_the_kernel_wrapper_at_or_below_1x(counted, rate, routed):
    cfg = SpeedyConfig(16000)
    xs = torch.as_tensor(speech_families(12000, 16000, 2, seed=4))
    lengths = torch.tensor([12000, 10300], dtype=torch.int32)
    out = batched_nonlinear_speedup(xs, lengths, cfg, rate)
    assert len(counted) == int(routed)
    if routed:
        assert counted[0] == tuple(out.tension.shape)
    batched_nonlinear_speedup(xs, lengths, cfg, rate, reference=True)
    assert len(counted) == int(routed)


def test_division_check_covers_the_law_range():
    """The kernel's division is proved on every float32 from kMinimumSpeed
    (the least denominator the law makes) to 2^126; the CPU has no card to
    run the proof on and raises."""
    lo, hi = kernels.DIVISION_CHECK_RANGE
    as_float = lambda bits: float(np.uint32(bits).view(np.float32))
    assert as_float(lo) == float(np.float32(0.01)) and as_float(hi) == 2.0 ** 126
    assert hi - lo == 1_113_336_054
    with pytest.raises(ValueError, match="on the card"):
        kernels.speed_law_division_check("cpu")
