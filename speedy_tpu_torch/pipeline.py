"""High-level pipelines for one utterance: waveform in, time-compressed
waveform out (port of speedy_tpu/pipeline.py, grid engine).

The functional equivalent of the reference's sonic2 shim data path
(soniclib.c:240-373): analysis frames feed Speedy, tension becomes speed,
and each frame's audio is resynthesized at its frame's speed. Frame k
(samples [k·step, (k+1)·step)) is played at the speed derived from
tension(k); the trailing lookahead frames run at the last computed speed
(soniclib.c:529-552).

Only the grid engine is ported. The JAX package's other engines ("scan",
"stream", "device-stream") raise NotImplementedError here, naming the
ROADMAP item that ports them: no call falls back to another engine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import config as C
from . import trace
from .config import SpeedyConfig
from .ops.analysis import analyze
from .ops.kernels import resolve_device
from .ops.speed import speed_from_tension
from .ops.wsola_fast import time_scale_grid

# What ports each engine the JAX package has besides "grid".
UNPORTED_ENGINES = {
    "scan": 'ROADMAP.md queue A, "The scan engine"',
    "stream": 'ROADMAP.md queue A, "Streaming"',
    "device-stream": 'ROADMAP.md queue A, "Streaming"',
}


class SpeedupResult(NamedTuple):
    output: np.ndarray       # int16 or float32 waveform (trimmed to length)
    tension: np.ndarray      # [T_out]
    speeds: np.ndarray       # [T_out] per-frame speeds sent to WSOLA
    achieved_rate: float     # input_len / output_len


def check_engine(engine: str) -> None:
    """Raise NotImplementedError unless engine is the ported "grid"."""
    if engine == "grid":
        return
    if engine in UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to PyTorch yet; "
            f"{UNPORTED_ENGINES[engine]} ports it"
        )
    raise ValueError(f"unknown engine {engine!r}")


def _as_float(x: np.ndarray) -> np.ndarray:
    """int16 scaled by 2^-15 (speedyAddDataShort); anything else float32."""
    if x.dtype == np.int16:
        return x.astype(np.float32) / 32768.0
    return x.astype(np.float32)


@trace.traced("input")
def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """x as float32 on device (_as_float, then one pageable copy)."""
    return trace.upload("input", _as_float(x), device=device)


@trace.traced("read-back")
def _result(x: np.ndarray, out, tension, speeds) -> SpeedupResult:
    """Trim to valid_length, read back, and round to int16 for int16 input.
    tension None (the --linear path has none) reads back as empty."""
    n = trace.read_back("valid_length", out.valid_length, int)
    y = trace.read_back("out", out.output[:n]).numpy()
    if x.dtype == np.int16:
        y = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    if tension is None:
        t = np.zeros(0, np.float32)
    else:
        t = trace.read_back("tension", tension).numpy()
    s = trace.read_back("speeds", speeds).numpy()
    return SpeedupResult(y, t, s, float(len(x)) / max(n, 1))


def nonlinear_speedup(
    x,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    engine: str = "scan",
    *,
    device="cuda",
    reference: bool = False,
) -> SpeedupResult:
    """Speedy nonlinear speedup of one mono utterance on `device` (the
    card unless the caller asks for the CPU; without a card, "cuda"
    raises).

    x may be int16 (scaled by 2^15 like speedyAddDataShort) or float in
    ±1; the output has x's type. The default duration_feedback_strength is
    the shim's (soniclib.c:122). nonlinear_factor=0 is pure linear WSOLA
    (soniclib.c:397-399). engine must be "grid"; the JAX package's default,
    "scan", is not ported yet and raises. reference=True runs the kernels'
    plain versions (on any device).
    """
    check_engine(engine)
    device = resolve_device(device)
    x = np.asarray(x)
    if nonlinear_factor == 0.0:
        return linear_time_scale(
            x, cfg, global_speed, engine=engine, device=device, reference=reference
        )
    with trace.layer("file"):
        xf = _upload(x, device)
        tension = analyze(xf, cfg, integer_step=True).tension
        if tension.shape[0] == 0:
            speeds = trace.upload("speed", [global_speed], dtype=torch.float32,
                                  device=xf.device)
        else:
            speeds = speed_from_tension(
                tension[None], global_speed, duration_feedback_strength, nonlinear_factor,
                reference=reference,
            )[0][0]
        if min_speed_bound is None:
            # The speeds are known: plan the buffers from them (one read-back).
            least = trace.read_back("speeds_min", speeds.min(), float)
            min_speed_bound = max(C.MIN_SPEED, least * 0.999)
        out = time_scale_grid(
            xf, speeds, cfg, min_speed_bound=min_speed_bound, device=device,
            reference=reference,
        )
        return _result(x, out, tension, speeds)


def linear_time_scale(
    x,
    cfg: SpeedyConfig,
    speed: float,
    engine: str = "scan",
    *,
    device="cuda",
    reference: bool = False,
) -> SpeedupResult:
    """Pure WSOLA at constant speed (original-libsonic behavior) on
    `device`; engine and reference as for nonlinear_speedup."""
    check_engine(engine)
    device = resolve_device(device)
    x = np.asarray(x)
    with trace.layer("file"):
        xf = _upload(x, device)
        speeds = trace.upload("speed", [speed], dtype=torch.float32, device=xf.device)
        out = time_scale_grid(
            xf, speeds, cfg, min_speed_bound=max(C.MIN_SPEED, speed * 0.999),
            device=device, reference=reference,
        )
        return _result(x, out, None, speeds)
