"""The PyTorch port's configuration, planning and constant tables against
the JAX package: equal plans, bitwise-equal tables, and an import that
leaves JAX out."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from speedy_tpu import config as jconfig
from speedy_tpu.ops import dft as jdft
from speedy_tpu.ops import wsola as jwsola
from speedy_tpu.ops import wsola_fast as jwf
from speedy_tpu.parallel import batch as jbatch

from speedy_tpu_torch import config as tconfig
from speedy_tpu_torch.ops import dft as tdft
from speedy_tpu_torch.ops import wsola as twsola
from speedy_tpu_torch.ops import wsola_fast as twf
from speedy_tpu_torch.parallel import batch as tbatch

RATES = [16000, 22050, 24000, 44100]


def _properties(cls):
    return [n for n, v in vars(cls).items() if isinstance(v, property)]


def test_module_constants_equal():
    names = [n for n in vars(jconfig) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconfig, n) == getattr(jconfig, n), n


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("match_matlab", [True, False])
def test_config_properties_equal(sr, match_matlab):
    j = jconfig.SpeedyConfig(sr, match_matlab)
    t = tconfig.SpeedyConfig(sr, match_matlab)
    assert _properties(tconfig.SpeedyConfig) == _properties(jconfig.SpeedyConfig)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)
    ]
    for name in _properties(jconfig.SpeedyConfig):
        assert getattr(t, name) == getattr(j, name), name
    for n in (0, 100, j.window_size, 16000, 160000):
        assert t.num_frames(n) == j.num_frames(n)
        assert t.num_frames(n, integer_step=True) == j.num_frames(n, integer_step=True)
    assert t.num_tension_frames(3) == j.num_tension_frames(3)
    assert t.bin_to_freq(17) == j.bin_to_freq(17)
    assert t.freq_to_bin(1234.5) == j.freq_to_bin(1234.5)


@pytest.mark.parametrize("sr", RATES)
def test_plans_equal(sr):
    j = jconfig.SpeedyConfig(sr)
    t = tconfig.SpeedyConfig(sr)
    for L in (100, 6000, 8270, 60000, 160000):
        for bound in (1.0, 0.21, 0.01):
            assert twsola.plan(t, L, bound) == jwsola.plan(j, L, bound)
            assert twf.plan_grid(t, L, bound) == jwf.plan_grid(j, L, bound)
        for rate, factor in ((3.5, 1.33), (3.0, None), (0.7, 1.5), (1.5, 1.1)):
            assert tbatch.grid_output_capacity(
                t, L, rate, factor
            ) == jbatch.grid_output_capacity(j, L, rate, factor)
    for hop in (None, 96, 160, 220, 441):
        assert twf.pitch_grid_stride(t, hop) == jwf.pitch_grid_stride(j, hop)
    for rate in (0.5, 0.7, 1.0, 1.5, 3.0, 3.5, 6.3):
        for nl in (0.0, 0.5, 1.0, 1.5):
            assert tbatch._plan_max_speed(rate, nl) == jbatch._plan_max_speed(rate, nl)


def test_grid_stride_matches_engine_formula():
    """wsola_grid_batch's G (wsola_fast.py:416 of the JAX package) is the
    one pitch_grid_stride reports, at every rate's default hop."""
    for sr in RATES:
        t = tconfig.SpeedyConfig(sr)
        hop = twf.default_hop(t)
        maxp = t.wsola_max_period
        inline = -(-max(3 * hop, maxp + maxp) // 128) * 128
        assert twf.pitch_grid_stride(t) == inline == twf._grid_stride(hop, maxp)


def _jax_tables(sr):
    """The JAX package's own tables for rate sr, as numpy arrays."""
    cfg = jconfig.SpeedyConfig(sr)
    W = cfg.window_size
    hop = max(32, cfg.frame_step_int)
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    M = jwf._pitch_dft_size(2 * maxp)
    ea, es, inv, band = jwf._pitch_corr_matrices(maxp, 2 * maxp, minp, maxp, M)
    cos_m, sin_m = jdft.dft_matrices(W)
    return {
        "hamming": np.asarray(jdft.hamming_window(W)),
        "dft_cos": np.asarray(cos_m), "dft_sin": np.asarray(sin_m),
        "cola": np.asarray(jwf._cola_hann(2 * hop)),
        "pitch_ea": ea, "pitch_es": es, "pitch_inv": inv, "pitch_band": band,
    }


@pytest.mark.parametrize("sr", RATES)
def test_tables_bitwise_equal(sr):
    ref = _jax_tables(sr)
    got = tbatch.build_tables(tconfig.SpeedyConfig(sr))
    assert sorted(got) == sorted(ref) == sorted(tbatch.TABLE_NAMES)
    for name, arr in ref.items():
        assert got[name].dtype == arr.dtype == np.float32, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    W = jconfig.SpeedyConfig(sr).window_size
    np.testing.assert_array_equal(tdft.hamming_window(W), jdft.hamming_window(W))
    for a, b in zip(tdft.dft_matrices(W), jdft.dft_matrices(W)):
        np.testing.assert_array_equal(a, b)
    for req in (300, 492, 510, 678, 1356):
        assert twf._pitch_dft_size(req) == jwf._pitch_dft_size(req)


def test_load_tables_round_trip():
    ref = _jax_tables(22050)
    eng = tbatch.SpeedupEngine(tconfig.SpeedyConfig(22050), 3.0)
    # Start from a state that differs from the JAX arrays everywhere.
    for name in tbatch.TABLE_NAMES:
        getattr(eng, name).fill_(-7.0)
    eng.load_tables(ref)
    for name, arr in ref.items():
        buf = getattr(eng, name)
        assert buf.dtype == torch.float32
        np.testing.assert_array_equal(buf.numpy(), arr, err_msg=name)
    assert set(dict(eng.named_buffers())) == set(
        tbatch.TABLE_NAMES + tbatch.DERIVED_TABLES
    )
    # The twiddle tables follow the loaded basis: cos and -sin of 2*pi*m/2W.
    W = ref["hamming"].shape[0]
    ang = 2.0 * np.pi * np.arange(2 * W) / (2 * W)
    np.testing.assert_allclose(eng.tw_cos.numpy(), np.cos(ang), atol=1e-7)
    np.testing.assert_allclose(eng.tw_sin.numpy(), -np.sin(ang), atol=1e-7)
    with pytest.raises(ValueError):
        eng.load_tables({"cola": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        eng.load_tables({"not_a_table": np.zeros(3, np.float32)})


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import speedy_tpu_torch\n"
        "import speedy_tpu_torch.ops.kernels, speedy_tpu_torch.ops._build\n"
        "import speedy_tpu_torch.cli, speedy_tpu_torch.io.wave\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'speedy_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent),
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
