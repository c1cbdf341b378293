"""The port's entry points run on the card unless the caller asks for the
CPU: called without `device` and without a card they raise, before any
work, and never fall back to the CPU."""

import inspect

import numpy as np
import pytest
import torch

from speedy_tpu_torch import SpeedyConfig, pipeline
from speedy_tpu_torch.cli import compress_sound
from speedy_tpu_torch.io import write_wave
from speedy_tpu_torch.ops import analysis, kernels, wsola_fast


@pytest.fixture()
def no_card(monkeypatch):
    """No CUDA device, and a failure if any stage of the pipeline runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*args, **kwargs):
        raise AssertionError("the pipeline ran without the card it was asked for")

    for module, name in ((pipeline, "analyze"), (analysis, "analyze"),
                         (wsola_fast, "wsola_grid_batch")):
        monkeypatch.setattr(module, name, ran)


def _calls(tmp_path):
    x = np.zeros(16000, np.float32)
    cfg = SpeedyConfig(16000)
    wav = tmp_path / "in.wav"
    write_wave(str(wav), x, 16000)
    return {
        "nonlinear_speedup": lambda: pipeline.nonlinear_speedup(x, cfg, 2.0, engine="grid"),
        "linear_time_scale": lambda: pipeline.linear_time_scale(x, cfg, 2.0, engine="grid"),
        "time_scale_grid": lambda: wsola_fast.time_scale_grid(x, np.full(99, 2.0), cfg),
        "compress_sound": lambda: compress_sound(str(wav), 2.0, 1.0, 0.1, engine="grid"),
    }


ENTRIES = {
    "nonlinear_speedup": pipeline.nonlinear_speedup,
    "linear_time_scale": pipeline.linear_time_scale,
    "time_scale_grid": wsola_fast.time_scale_grid,
    "compress_sound": compress_sound,
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_points_default_to_the_card(no_card, tmp_path, entry):
    assert inspect.signature(ENTRIES[entry]).parameters["device"].default == "cuda"
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _calls(tmp_path)[entry]()
    assert not any(kernels.LAUNCHES.values())


def test_resolve_device_keeps_what_was_asked():
    assert kernels.resolve_device("cpu") == torch.device("cpu")
    assert kernels.resolve_device(torch.device("cpu")) == torch.device("cpu")
