"""Kernel 1's FFT on the CPU: the plan ops/analysis_fft.py picks from W,
its tables against their float64 definitions, and its float32 model of
the kernel's stages against numpy's float64 rfft and against the JAX
package's analysis. csrc/analysis.cu runs this plan with these tables on
the card, where chip_smoke.py holds it to the plain version."""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speedy_tpu.ops.pallas_kernels as pk
from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.ops import filters as jfilters
from speedy_tpu.parallel import batch as jbatch

from speedy_tpu_torch.config import SpeedyConfig
from speedy_tpu_torch.ops import analysis, analysis_fft, dft, kernels
from speedy_tpu_torch.parallel import batch

import testutil

# Rate -> (route, stage radices): W = 120, 165, 240, 330, 661 (a prime), 720.
PLANS = {
    8000: ("stockham", (2, 4, 3, 5)),
    11025: ("stockham", (3, 5, 11)),
    16000: ("stockham", (2, 8, 3, 5)),
    22050: ("stockham", (2, 3, 5, 11)),
    44100: ("direct", ()),
    48000: ("stockham", (2, 8, 3, 3, 5)),
    # The direct sum off the FFT rates: W = 105 and 180 (not mirrored),
    # 709 (a prime, mirrored) and 1440, the last two in several rounds of
    # pairs.
    7000: ("direct", ()),
    12000: ("direct", ()),
    47300: ("direct", ()),
    96000: ("direct", ()),
}
GAIN = np.array([1.0, 0.7, 1.4], np.float32)


def _largest_prime_factor(n: int) -> int:
    p, out = 2, 1
    while n > 1:
        while n % p == 0:
            n //= p
            out = p
        p += 1
    return out


@pytest.mark.parametrize("sr", sorted(PLANS))
def test_plan_at_each_rate(sr):
    W = SpeedyConfig(sr).window_size
    plan = analysis_fft.fft_plan(W)
    assert (plan.route, plan.radices) == PLANS[sr]
    assert plan.W == W and plan.zero_half == (plan.route == "stockham" and W % 2 == 0)
    code = analysis_fft.radix_code(plan)
    assert [(code >> (4 * i)) & 15 for i in range(len(plan.radices))] == list(plan.radices)
    assert code >> (4 * len(plan.radices)) == 0
    if plan.route == "stockham":
        assert int(np.prod(plan.radices)) == W


@pytest.mark.parametrize("W_lo", [2, 200, 400, 600, 800])
def test_plan_picks_the_fft_exactly_for_the_compiled_windows(W_lo):
    """The FFT for the W of FFT_WINDOWS, every one of them a product of
    the kernel's radices; the direct sum for every other W, among them
    every W with a prime factor above 11."""
    for W in range(W_lo, W_lo + 200):
        plan = analysis_fft.fft_plan(W)
        assert (plan.route == "stockham") == (W in analysis_fft.FFT_WINDOWS), W
        if plan.route == "direct":
            assert plan.radices == () and analysis_fft.radix_code(plan) == 0
            continue
        assert _largest_prime_factor(W) <= 11
        assert set(plan.radices) <= set(analysis_fft.RADICES)
        assert int(np.prod(plan.radices)) == W
        # Stage one is the zero-padding radix 2 exactly for an even W: z's
        # support ceil(W/2) then fits the lower half.
        assert plan.zero_half == (W % 2 == 0)
        if plan.zero_half:
            assert plan.radices[0] == 2
    with pytest.raises(ValueError):
        analysis_fft.fft_plan(1)


def _is_prime(n: int) -> bool:
    return n > 1 and _largest_prime_factor(n) == n


@pytest.mark.parametrize("W_lo", [2, 200, 400, 600, 800])
def test_direct_plan_mirrors_exactly_at_every_prime(W_lo):
    """The direct sum's pairing decision against the float32 table, read
    one pair at a time: bin W-k's entry at sample n is bin k's times
    ((-1)^n, -(-1)^n) at every n < W for every pair k < W/2. True at
    every prime W (W = 661 among them), false at W = 105 and 180 (7 and
    12 kHz), and passed to the kernel as code 1 or 0."""
    for W in range(W_lo, W_lo + 200):
        plan = analysis_fft.fft_plan(W)
        if plan.route != "direct":
            assert not plan.mirrored
            continue
        tw = analysis_fft.fft_tables(W)["twiddle"]
        exact = True
        for k in range(1, (W - 1) // 2 + 1):
            n = np.arange(W)
            own, pair = tw[k * n % (2 * W)], tw[(W - k) * n % (2 * W)]
            odd = n % 2 == 1
            want = np.stack([np.where(odd, -own[:, 0], own[:, 0]),
                             np.where(odd, own[:, 1], -own[:, 1])], axis=-1)
            if not np.array_equal(pair, want):
                exact = False
                break
        assert plan.mirrored == exact, W
        assert analysis_fft.kernel_code(plan) == int(exact)
        if _is_prime(W):
            assert plan.mirrored, W
    for W in (105, 180):
        assert analysis_fft.fft_plan(W).route == "direct"
        assert not analysis_fft.fft_plan(W).mirrored
    assert analysis_fft.fft_plan(661).mirrored
    assert SpeedyConfig(44100).window_size == 661
    assert [SpeedyConfig(sr).window_size for sr in (7000, 12000)] == [105, 180]
    assert [SpeedyConfig(sr).window_size for sr in (47300, 96000)] == [709, 1440]
    assert analysis_fft.fft_plan(709).mirrored and not analysis_fft.fft_plan(1440).mirrored


def test_compiled_windows_match_the_kernel_source():
    """csrc/analysis.cu's fft_kernel_for has a body for exactly the W of
    FFT_WINDOWS, the windows of the sample rates they stand for."""
    src = (pathlib.Path(analysis_fft.__file__).parent.parent / "csrc" / "analysis.cu")
    cases = re.findall(r"case (\d+): return fft_kernel<(\d+)>;", src.read_text())
    assert all(a == b for a, b in cases)
    assert sorted(int(a) for a, _ in cases) == sorted(analysis_fft.FFT_WINDOWS)
    rates = (8000, 11025, 16000, 22050, 24000, 32000, 48000)
    assert sorted(SpeedyConfig(sr).window_size for sr in rates) == sorted(
        analysis_fft.FFT_WINDOWS)


@pytest.mark.parametrize("sr", sorted(PLANS))
def test_tables_against_float64(sr):
    W = SpeedyConfig(sr).window_size
    plan = analysis_fft.fft_plan(W)
    tabs = analysis_fft.fft_tables(W)
    assert all(t.dtype == np.float32 for t in tabs.values())
    packed = analysis_fft.packed_table(W)
    assert packed.shape == (2 * W, 2) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed, np.concatenate(list(tabs.values())))
    # Each entry is its float64 value rounded once: within half a float32
    # ulp of 1 (2^-24) per component.
    ulp = 2.0 ** -24
    if plan.route == "direct":
        assert sorted(tabs) == ["twiddle"]
        m = np.arange(2 * W)
        want = np.exp(-2j * np.pi * m / (2 * W))
        np.testing.assert_allclose(tabs["twiddle"][:, 0], want.real, rtol=0, atol=ulp)
        np.testing.assert_allclose(tabs["twiddle"][:, 1], want.imag, rtol=0, atol=ulp)
        # Bitwise the DFT basis' n = 1 row (bins 0..W) and its mirror, the
        # tables the direct sum has always read.
        cos_m, sin_m = dft.dft_matrices(W)
        np.testing.assert_array_equal(
            tabs["twiddle"][:, 0], np.concatenate([cos_m[1], cos_m[1, 1:W][::-1]]))
        np.testing.assert_array_equal(
            tabs["twiddle"][:, 1], np.concatenate([sin_m[1], -sin_m[1, 1:W][::-1]]))
        return
    assert sorted(tabs) == ["post", "twiddle"]
    m = np.arange(W)
    for name, want in (("twiddle", np.exp(-2j * np.pi * m / W)),
                       ("post", np.exp(-1j * np.pi * m / W))):
        np.testing.assert_allclose(tabs[name][:, 0], want.real, rtol=0, atol=ulp)
        np.testing.assert_allclose(tabs[name][:, 1], want.imag, rtol=0, atol=ulp)


def _frames(W, n, seed):
    """Windowed frames: noise, a voiced tone, a decaying click, silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(W)
    win = np.hamming(W)
    rows = [rng.standard_normal(W) * win for _ in range(n - 3)]
    rows.append(0.4 * np.sin(2 * np.pi * 0.037 * t) * win)
    rows.append(np.exp(-t / 9.0) * win)
    rows.append(np.zeros(W))
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("sr", sorted(PLANS))
def test_model_matches_float64_rfft(sr):
    W = SpeedyConfig(sr).window_size
    frames = _frames(W, 9, sr)
    got = analysis_fft.spectrum_model(torch.as_tensor(frames)).numpy()
    ref = np.abs(np.fft.rfft(frames.astype(np.float64), n=2 * W))[:, :W]
    assert got.shape == ref.shape and got.dtype == np.float32
    # A float32 FFT's error grows as log2 of its length: within 2e-6 of
    # each frame's largest bin (the model keeps 1-3e-7), bins 1..W-1; a
    # silent frame's spectrum is exactly zero.
    err = np.abs(got - ref)[:, 1:].max(axis=1)
    scale = np.maximum(ref.max(axis=1), 1e-30)
    assert np.all(err <= 2e-6 * scale), (err / scale).max()
    assert np.all(got[-1] == 0.0)


def _analysis_batch(L, sr):
    """Voiced, noise and bursty rows (as tests/test_torch_frontend.py)."""
    rng = np.random.default_rng(7)
    t = np.arange(L) / sr
    voiced = (
        np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None)
    ).astype(np.float32) * 0.4
    noise = rng.standard_normal(L).astype(np.float32) * 0.05
    bursty = np.zeros(L, np.float32)
    bursty[L // 8 : L // 8 + L // 4] = voiced[: L // 4]
    return np.stack([voiced, noise, bursty])


def _model_energy_lsd(xs, cfg, T):
    """Kernel 1's function with its spectrum from the FFT model: the plain
    version's framing and reductions around spectrum_model."""
    W = cfg.window_size
    ham = torch.as_tensor(batch.build_tables(cfg)["hamming"])
    fw = kernels.windowed_frames(torch.as_tensor(xs), torch.as_tensor(GAIN), ham, T,
                                 cfg.frame_step_int)
    half = analysis_fft.spectrum_model(fw.reshape(-1, W)).reshape(fw.shape)
    return kernels.energy_lsd(half)


@pytest.mark.parametrize("sr,L", [(16000, 32000), (22050, 44100), (44100, 88200)])
def test_model_matches_jax_analysis(monkeypatch, sr, L):
    """The model's energy and lsd against the JAX package's analysis with
    chip_smoke.check_analysis' tolerances, and its tension against the JAX
    package's XLA chain (speedy_tpu/parallel/batch.py:171-253, the path it
    takes on the CPU) with outliers only at 40 dB mask edges. The energy
    is the chain's own, read where it enters the first low-pass; the lsd
    is the Pallas kernel's (interpret mode, full float32 products) where
    its geometry serves the rate, and at 44.1 kHz, where it does not, a
    float64 one from numpy's rfft of the same frames. At 44.1 kHz the
    model is the direct sum's."""
    monkeypatch.setenv("SPEEDY_ANALYSIS_PRECISION", "highest")
    cfg = SpeedyConfig(sr)
    W, step = cfg.window_size, cfg.frame_step_int
    xs = _analysis_batch(L, sr)
    T = cfg.num_frames(L, integer_step=True)
    e_m, l_m = (t.numpy() for t in _model_energy_lsd(xs, cfg, T))

    entered = []
    lowpass = jfilters.first_order_lowpass

    def record(x, *args, **kwargs):
        entered.append(np.asarray(x))
        return lowpass(x, *args, **kwargs)

    monkeypatch.setattr(jfilters, "first_order_lowpass", record)
    t_j = np.asarray(
        jbatch.batched_analysis(jnp.asarray(xs), JConfig(sr), T, gain=jnp.asarray(GAIN))
    )
    e_j = entered[0]
    assert e_j.shape == e_m.shape == (3, T)
    assert np.all(np.abs(e_m - e_j) <= 1e-6 + 1e-5 * np.abs(e_j))

    if pk._analysis_geometry(W, step) is not None:
        _, l_r = pk.analysis_energy_lsd_pallas(
            jnp.asarray(xs), T, W, step, gain=jnp.asarray(GAIN),
            precision="highest", interpret=True,
        )
        l_r = np.asarray(l_r)
    else:
        ham = batch.build_tables(cfg)["hamming"]
        fw = kernels.windowed_frames(torch.as_tensor(xs), torch.as_tensor(GAIN),
                                     torch.as_tensor(ham), T, step).double().numpy()
        half = np.abs(np.fft.rfft(fw, n=2 * W, axis=-1))[..., :W]
        l_r = kernels.energy_lsd(torch.as_tensor(half))[1].numpy()
    # lsd[:, 0] is don't-care; per utterance at most 2 frames beyond
    # 2e-4*max(scale, 1), and relative error below 1e-2.
    dl = np.abs(l_m[:, 1:] - l_r[:, 1:])
    for b in range(len(xs)):
        scale = float(np.abs(l_r[b]).max())
        assert int((dl[b] > 2e-4 * max(scale, 1.0)).sum()) <= 2
        assert float((dl[b] / (np.abs(l_r[b, 1:]) + 1.0)).max()) < 1e-2

    T_out = cfg.num_tension_frames(T)
    t_m = analysis.tension_chain(
        torch.as_tensor(e_m), torch.as_tensor(l_m[:, :T_out]), cfg, T_out
    ).tension.numpy()
    assert t_m.shape == t_j.shape == (3, T_out)
    for b in range(3):
        testutil.assert_tension_outliers_are_mask_edges(
            xs[b], cfg, T, np.abs(t_m[b] - t_j[b]), outlier_thresh=2e-5
        )


@pytest.mark.parametrize("sr", [16000, 44100])
def test_engine_derives_the_fft_tables(sr):
    cfg = SpeedyConfig(sr)
    W = cfg.window_size
    want = analysis_fft.packed_table(W)
    eng = batch.SpeedupEngine(cfg, 3.0)
    assert "analysis_fft" in batch.DERIVED_TABLES
    np.testing.assert_array_equal(eng.analysis_fft.numpy(), want)
    np.testing.assert_array_equal(eng.tables()["analysis_fft"].numpy(), want)
    eng.analysis_fft.zero_()
    eng.load_tables({"hamming": batch.build_tables(cfg)["hamming"]})
    np.testing.assert_array_equal(eng.analysis_fft.numpy(), want)
    np.testing.assert_array_equal(batch.device_tables(cfg, "cpu")["analysis_fft"].numpy(), want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cfg = SpeedyConfig(16000)
    xs = _analysis_batch(8000, 16000)
    T = cfg.num_frames(8000, integer_step=True)
    tab = batch.device_tables(cfg, "cpu")
    args = (torch.as_tensor(xs), torch.as_tensor(GAIN), tab["hamming"], tab["dft_cos"],
            tab["dft_sin"], tab["analysis_fft"], T, cfg.frame_step_int)
    kernels.reset_launches()
    got = kernels.analysis_energy_lsd(*args)
    want = kernels.analysis_energy_lsd_reference(*args)
    assert not any(kernels.LAUNCHES.values())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
