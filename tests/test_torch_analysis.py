"""The PyTorch port's single-utterance analysis (ops/analysis.py::analyze and
its framing, spectrogram, hysteresis and lowpass) against the JAX
package's on the CPU, on the same seeded inputs.

Tolerances: spectrogram within 1e-5 of each utterance's largest value
(both are float32 matmuls against the same basis, summed in another
order); normalized spectrogram within 1e-5 on every frame whose spectral
energy is above 1e-30 (below it the squared bins are float32 subnormals,
which XLA on the CPU flushes to zero and torch does not; such frames are
far under the low-energy threshold, so skipped, and carry no tension);
the energy feature columns within 1e-5 relative; tension within 2e-5
except at 40 dB mask-edge frames (tests/test_chunked.py:38); frame
indices, threshold and skip flags equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.ops import analysis as janalysis
from speedy_tpu.ops import dft as jdft
from speedy_tpu.ops import framing as jframing
from speedy_tpu.ops import hysteresis as jhyst

from speedy_tpu_torch import analyze
from speedy_tpu_torch.config import SpeedyConfig
from speedy_tpu_torch.ops import dft, framing, hysteresis

from torch_port_util import assert_tension_gate, speech_families

ENERGY_COLUMNS = [0, 1, 2, 3, 4]
EXACT_COLUMNS = [5, 12, 13, 14]


def _assert_close_to_scale(got, ref, rel, what):
    if ref.size == 0:
        return
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (what, err, scale)


def _assert_analysis_matches(x, cfg, integer_step):
    rj = janalysis.analyze_jit(x, JConfig(cfg.sample_rate), integer_step=integer_step)
    rt = analyze(torch.as_tensor(x), cfg, integer_step=integer_step)
    for name in ("spectrogram", "normalized", "features", "tension"):
        assert tuple(getattr(rt, name).shape) == tuple(getattr(rj, name).shape), name
    _assert_close_to_scale(rt.spectrogram.numpy(), np.asarray(rj.spectrogram), 1e-5,
                           "spectrogram")
    f_t, f_j = rt.features.numpy(), np.asarray(rj.features)
    audible = f_j[:, 0] > 1e-30
    assert np.all(f_t[~audible, 5] == 1.0)
    _assert_close_to_scale(rt.normalized.numpy()[audible],
                           np.asarray(rj.normalized)[audible], 1e-5, "normalized")
    np.testing.assert_allclose(f_t[:, ENERGY_COLUMNS], f_j[:, ENERGY_COLUMNS],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(f_t[:, EXACT_COLUMNS], f_j[:, EXACT_COLUMNS])
    np.testing.assert_array_equal(f_t[:, 11], rt.tension.numpy())
    T = cfg.num_frames(len(x), integer_step)
    assert_tension_gate(x, cfg, T, np.asarray(rj.tension), rt.tension.numpy(),
                        integer_step)
    return rt, rj


@pytest.mark.parametrize("integer_step", [True, False])
@pytest.mark.parametrize("sr", [16000, 22050])
def test_analyze_matches_jax_on_speech_families(sr, integer_step):
    cfg = SpeedyConfig(sr)
    xs = speech_families(int(1.5 * sr), sr, 4, seed=5)
    for x in xs:
        _assert_analysis_matches(x, cfg, integer_step)


def test_analyze_all_zero_input():
    cfg = SpeedyConfig(16000)
    rt, rj = _assert_analysis_matches(np.zeros(16000, np.float32), cfg, True)
    tension = rt.tension.numpy()
    assert np.all(tension == np.asarray(rj.tension))
    assert np.all(tension == np.float32(-0.6)), np.unique(tension)
    assert np.all(rt.features.numpy()[:, 5] == 1.0)  # every frame skipped


@pytest.mark.parametrize("L", [0, 100, 239])
def test_analyze_shorter_than_a_window(L):
    cfg = SpeedyConfig(16000)
    W = cfg.window_size
    rt = analyze(torch.zeros(L), cfg, integer_step=True)
    rj = janalysis.analyze_jit(np.zeros(L, np.float32), JConfig(16000), integer_step=True)
    assert tuple(rt.spectrogram.shape) == np.asarray(rj.spectrogram).shape == (0, W + 1)
    assert tuple(rt.normalized.shape) == (0, W)
    assert tuple(rt.features.shape) == (0, 15)
    assert tuple(rt.tension.shape) == (0,)


@pytest.mark.parametrize("L", [400, 900, 1519])
def test_analyze_frames_without_tension(L):
    """2 <= T <= hysteresis_future frames give no tension frame. The JAX
    package's analyze raises there (its frame t-1 slice half[:T_out - 1]
    wraps to half[:-1] when T_out = 0, and the shapes then fail to
    broadcast); the port returns an empty tension and the JAX package's
    spectrogram of the frames that exist."""
    cfg = SpeedyConfig(16000)
    x = speech_families(L, 16000, 1, seed=3)[0]
    T = cfg.num_frames(L, integer_step=True)
    assert 2 <= T <= cfg.hysteresis_future
    with pytest.raises(TypeError):
        janalysis.analyze_jit(x, JConfig(16000), integer_step=True)
    rt = analyze(torch.as_tensor(x), cfg, integer_step=True)
    assert tuple(rt.tension.shape) == (0,)
    assert tuple(rt.features.shape) == (0, 15)
    jc = JConfig(16000)
    starts = jnp.asarray(jframing.frame_starts(jc, T, True))
    pre = jframing.preemphasize(
        jframing.extract_frames(jnp.asarray(x), starts, cfg.window_size),
        jframing.preemphasis_state(jnp.asarray(x), starts, cfg.window_size),
    )
    spec_j = np.asarray(jdft.magnitude_spectrogram(pre, jc))
    _assert_close_to_scale(rt.spectrogram.numpy(), spec_j, 1e-5, "spectrogram")


def test_analyze_batch_matches_per_utterance():
    cfg = SpeedyConfig(16000)
    xs = speech_families(12000, 16000, 3, seed=9)
    T = cfg.num_frames(12000, integer_step=True)
    rb = analyze(torch.as_tensor(xs), cfg, T, integer_step=True)
    for b in range(3):
        r1 = analyze(torch.as_tensor(xs[b]), cfg, T, integer_step=True)
        for got, want in zip(rb, r1):
            torch.testing.assert_close(got[b], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("integer_step", [True, False])
def test_framing_matches_jax(integer_step):
    cfg = SpeedyConfig(22050)
    x = speech_families(9000, 22050, 1, seed=2)[0]
    T = cfg.num_frames(len(x) + 200, integer_step)  # the last frames clip
    W = cfg.window_size
    starts = framing.frame_starts(cfg, T, integer_step)
    np.testing.assert_array_equal(
        starts, jframing.frame_starts(JConfig(22050), T, integer_step)
    )
    xt, xj, st = torch.as_tensor(x), jnp.asarray(x), torch.as_tensor(starts)
    frames = framing.extract_frames(xt, st, W)
    state = framing.preemphasis_state(xt, st, W)
    np.testing.assert_array_equal(
        frames.numpy(), np.asarray(jframing.extract_frames(xj, jnp.asarray(starts), W))
    )
    np.testing.assert_array_equal(
        state.numpy(), np.asarray(jframing.preemphasis_state(xj, jnp.asarray(starts), W))
    )
    pre_j = np.asarray(jframing.preemphasize(jnp.asarray(frames.numpy()),
                                             jnp.asarray(state.numpy())))
    # XLA contracts x - 0.97*prev into one FMA; torch rounds twice.
    one_rounding = np.finfo(np.float32).eps * float(np.abs(x).max())
    np.testing.assert_allclose(framing.preemphasize(frames, state).numpy(), pre_j,
                               rtol=0, atol=one_rounding)


def test_full_magnitude_matches_jax():
    cfg = SpeedyConfig(16000)
    half = np.random.default_rng(4).uniform(0, 1, (5, cfg.window_size + 1))
    half = half.astype(np.float32)
    full = dft.full_magnitude(torch.as_tensor(half), cfg).numpy()
    np.testing.assert_array_equal(
        full, np.asarray(jdft.full_magnitude(jnp.asarray(half), JConfig(16000)))
    )
    assert full.shape == (5, cfg.fft_size)


@pytest.mark.parametrize("T,num_out", [(40, 32), (9, 1), (12, 4)])
def test_hysteresis_matches_jax(T, num_out):
    # num_out <= T, as for every caller (num_out = T - future).
    values = np.random.default_rng(T).uniform(-0.2, 1.5, T).astype(np.float32)
    want = np.asarray(jhyst.tapered_max_hysteresis(jnp.asarray(values), 8, 12, num_out))
    got = hysteresis.tapered_max_hysteresis(torch.as_tensor(values), 8, 12, num_out)
    np.testing.assert_array_equal(got.numpy(), want)
