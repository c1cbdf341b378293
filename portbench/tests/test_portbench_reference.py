"""The plain reference against the port's own plain path (reference=True,
on the CPU) at small sizes, in both entries: the same answers to float32
rounding."""

import numpy as np
import pytest
import torch

from portbench import judge, traffic_gen
from portbench.reference import plain

RATE, NL, FB, CAP = 3.5, 1.0, 0.1, 1.33


def numbers(tension, r_tension, speeds, r_speeds, out, r_out, valid, r_valid):
    """The judge's numbers, with the largest tension and speed gaps of any
    frame beside them."""
    tally = judge.Tally()
    tally.add(tension, r_tension, speeds, r_speeds, out, r_out, valid, r_valid)
    n = tally.numbers()
    n["tension_max"] = float(torch.cat(tally.tension).max()) if tally.tension else 0.0
    n["speed_max"] = float(torch.cat(tally.speeds).max())
    return n


def test_batch_entry_matches_the_ports_plain_path():
    import speedy_tpu_torch as port

    L, B = 48000, 8
    xs = torch.as_tensor(traffic_gen.families(L, 16000))[torch.arange(B) % 4].contiguous()
    gain = torch.linspace(0.5, 0.99, B)
    res = port.batched_nonlinear_speedup(
        xs, torch.full((B,), L, dtype=torch.int32), port.SpeedyConfig(16000), RATE, NL, FB,
        gain=gain, capacity_factor=CAP, reference=True)
    ref = plain.Plain(16000).batch(xs, gain, RATE, NL, FB, CAP)
    assert ref.output.shape == res.output.shape
    n = numbers(res.tension, ref.tension, res.speeds, ref.speeds, res.output, ref.output,
                res.valid_length, ref.valid)
    assert n["tension_max"] < 2e-5 and n["speed_max"] < 2e-5
    assert n["length_gap_max"] == 0 and n["audio_err_max"] < 1e-9


@pytest.mark.parametrize("nl", [1.0, 0.0])
def test_file_entry_matches_the_ports_plain_path(nl):
    from speedy_tpu_torch import SpeedyConfig, pipeline

    fam = traffic_gen.families(16000 * 6, 16000)
    for f in range(4):
        x = np.round(fam[f] * 0.7 * 32768).astype(np.int16)
        res = pipeline.nonlinear_speedup(x, SpeedyConfig(16000), RATE, nl, FB, engine="grid",
                                         device="cpu", reference=True)
        ref = plain.Plain(16000).file(x, RATE, nl, FB)
        y = plain.to_int16(ref.output[0, : int(ref.valid[0])])
        scale = lambda a: torch.from_numpy(a.astype(np.float32) / 32768.0)[None]
        n = numbers(torch.from_numpy(res.tension)[None], ref.tension,
                    torch.from_numpy(res.speeds)[None], ref.speeds, scale(res.output), scale(y),
                    torch.tensor([len(res.output)]), torch.tensor([len(y)]))
        assert n["tension_max"] < 2e-5 and n["speed_max"] < 2e-5
        assert n["length_gap_max"] == 0 and n["audio_err_max"] < 1e-9


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12])
    y = plain.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2 * 2**-10, -3.0]
