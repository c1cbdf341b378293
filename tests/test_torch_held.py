"""The held constants (speedy_tpu_torch/held.py) on the CPU: one device
tensor a (site, key, dtype, device), uploaded once through trace.upload
and counted there, dropped least recent first past the cache's bounds or
all at once by clear_held(), and collected by held_reads() for what keeps
using them (a CUDA graph that captured them)."""

import numpy as np
import pytest
import torch

from speedy_tpu_torch import held, trace


def test_upload_once_holds_one_tensor_a_key():
    held.clear_held()
    trace.reset()
    cpu = torch.device("cpu")
    a = held.upload_once("s", 0.97, torch.float32, cpu)
    assert held.upload_once("s", 0.97, torch.float32, "cpu") is a
    assert a.dtype == torch.float32 and torch.equal(a, torch.tensor(0.97))
    table = np.arange(6, dtype=np.float64)
    t = held.upload_once("t", table, torch.float32, cpu, key=(6, 0))
    assert held.upload_once("t", table, torch.float32, cpu, key=(6, 0)) is t
    assert trace.SYNCS == {"s": 1, "t": 1}
    assert trace.SYNC_BYTES == {"s": 4, "t": 24}
    held.clear_held()
    assert held.upload_once("s", 0.97, torch.float32, cpu) is not a
    assert trace.SYNCS["s"] == 2


@pytest.mark.parametrize("other", [
    ("s", 0.5, torch.float32, None),      # another value
    ("s", 0.97, torch.float64, None),     # another dtype
    ("u", 0.97, torch.float32, None),     # another site
    ("s", -0.0, torch.float32, None),     # -0.0 against 0.0 below
    ("s", 1, torch.float32, None),        # an int against 1.0 below
    ("t", np.zeros(5), torch.float32, (5, 0)),  # another table shape
    ("t", np.zeros(6), torch.float32, (6, 1)),  # another table of one shape
])
def test_upload_once_misses_on_another_key(other):
    held.clear_held()
    trace.reset()
    cpu = torch.device("cpu")
    kept = [held.upload_once("s", v, torch.float32, cpu) for v in (0.97, 0.0, 1.0)]
    kept.append(held.upload_once("t", np.zeros(6), torch.float32, cpu, key=(6, 0)))
    site, data, dtype, key = other
    got = held.upload_once(site, data, dtype, cpu, key=key)
    assert all(got is not h for h in kept)
    fresh = torch.as_tensor(data, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, fresh)
    assert torch.equal(torch.signbit(got), torch.signbit(fresh))  # -0.0 stays -0.0
    assert sum(trace.SYNCS.values()) == 5


def test_upload_once_needs_a_key_for_anything_but_a_number():
    for data in (np.zeros(3), torch.zeros(3), np.float32(0.5)):
        with pytest.raises(TypeError, match="needs a key"):
            held.upload_once("s", data, torch.float32, "cpu")


def test_upload_once_drops_the_least_recent_past_its_bounds(monkeypatch):
    held.clear_held()
    trace.reset()
    monkeypatch.setattr(held, "HELD_MAX", 3)
    first = [held.upload_once("s", float(v), torch.float32, "cpu") for v in range(3)]
    assert held.upload_once("s", 0.0, torch.float32, "cpu") is first[0]  # 0.0 now newest
    held.upload_once("s", 3.0, torch.float32, "cpu")  # drops 1.0
    assert len(held._held) == 3
    assert held.upload_once("s", 0.0, torch.float32, "cpu") is first[0]
    assert held.upload_once("s", 1.0, torch.float32, "cpu") is not first[1]
    assert len(held._held) == 3 and trace.SYNCS == {"s": 5}
    held.clear_held()
    monkeypatch.setattr(held, "HELD_MAX_BYTES", 100)
    big = held.upload_once("t", np.zeros(20), torch.float32, "cpu", key=20)  # 80 bytes
    held.upload_once("t", np.zeros(5), torch.float32, "cpu", key=5)  # 100 bytes: kept
    assert held.upload_once("t", np.zeros(20), torch.float32, "cpu", key=20) is big
    held.upload_once("t", np.zeros(30), torch.float32, "cpu", key=30)  # 120 alone: kept
    assert list(held._held) == [("t", 30, torch.float32, torch.device("cpu"))]
    assert held._held_bytes == 120
    held.clear_held()
    assert held._held_bytes == 0 and not held._held


def test_held_reads_collect_what_upload_once_hands_out_inside_the_block():
    held.clear_held()
    before = held.upload_once("t_reads", 1.0, torch.float32, "cpu")
    with held.held_reads() as reads:
        hit = held.upload_once("t_reads", 1.0, torch.float32, "cpu")
        miss = held.upload_once("t_reads", 2.0, torch.float32, "cpu")
    held.upload_once("t_reads", 3.0, torch.float32, "cpu")
    assert hit is before and len(reads) == 2
    assert reads[0] is hit and reads[1] is miss
    assert held._readers == []
