"""The traffic generator against the copy it was taken from, and the same
work in every run whatever the seed."""

import importlib.util

import numpy as np
import torch

from portbench import traffic_gen
from portbench.tests.small import ROOT

CONFIG = {"sample_rate": 16000}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_families_are_chip_smokes():
    smoke = chip_smoke()
    for L in (4000, 16001):
        assert np.array_equal(traffic_gen.families(L, 16000), smoke.bench_families(L, 16000))


def test_batch_rows_take_family_b_mod_4():
    traffic = {"batch": 6, "utterance_s": 0.25, "families": [0, 1, 2, 3]}
    xs = traffic_gen.batch_rows(traffic, CONFIG, "cpu")
    fam = traffic_gen.families(4000, 16000)
    assert xs.shape == (6, 4000)
    for b in range(6):
        assert np.array_equal(xs[b].numpy(), fam[b % 4])


def test_gain_bank_is_the_seeds():
    traffic = {"batch": 8, "gain": [0.5, 1.0], "gain_bank": 64}
    seed = 2**33 + 5
    a = traffic_gen.gain_bank(traffic, seed, "cpu")
    assert torch.equal(a, traffic_gen.gain_bank(traffic, seed, "cpu"))
    assert not torch.equal(a, traffic_gen.gain_bank(traffic, seed + 1, "cpu"))
    assert a.shape == (64, 8) and float(a.min()) >= 0.5 and float(a.max()) < 1.0


def test_file_pool_is_the_same_work_for_every_seed():
    traffic = {"file_s": 0.5, "pool": 8, "families": [0, 1, 2, 3], "gain": [0.5, 1.0]}
    a = traffic_gen.file_pool(traffic, CONFIG, 7)
    b = traffic_gen.file_pool(traffic, CONFIG, 2**40)
    assert [f for f, _ in a] == [0, 1, 2, 3, 0, 1, 2, 3] == [f for f, _ in b]
    assert all(x.dtype == np.int16 and x.shape == (8000,) for _, x in a + b)
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    again = traffic_gen.file_pool(traffic, CONFIG, 7)
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, again))
