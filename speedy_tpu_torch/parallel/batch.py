"""Batch engine on one device (port of speedy_tpu/parallel/batch.py's mono
grid path): xs [B, L] -> analysis front-end -> tension -> speed law ->
grid WSOLA -> [B, capacity] audio.

The engine is a pure function of the audio; its only "weights" are the
constant tables it shares with the JAX package (Hamming window, DFT basis,
COLA window, pitch correlation matrices). SpeedupEngine holds them as
buffers and load_tables() carries the JAX package's own arrays across.

On a CUDA device batched_nonlinear_speedup switches TF32 off for matmuls
and cuDNN (no_tf32), so every float32 product runs in full float32: the
TPU pitch path needed full float32, and the analysis here is at least as
precise as the TPU's bf16x3.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import config as C
from .. import trace
from ..config import SpeedyConfig
from ..ops import analysis, analysis_fft, dft, kernels, wsola, wsola_fast
from ..ops.dft import no_tf32
from ..ops.speed import speed_from_tension, speed_from_tension_parallel

TABLE_NAMES = (
    "hamming", "dft_cos", "dft_sin", "cola",
    "pitch_ea", "pitch_es", "pitch_inv", "pitch_band",
)
# Kernel 1's FFT tables (analysis_fft.packed_table), derived from W.
DERIVED_TABLES = ("analysis_fft",)


class BatchResult(NamedTuple):
    output: torch.Tensor        # [B, capacity] float32
    valid_length: torch.Tensor  # [B] int32
    tension: torch.Tensor       # [B, T_out]
    speeds: torch.Tensor        # [B, T_out]


def build_tables(cfg: SpeedyConfig) -> Dict[str, np.ndarray]:
    """The constant tables for cfg, as numpy float32 arrays, built with the
    JAX package's recipes."""
    W = cfg.window_size
    hop = wsola_fast.default_hop(cfg)
    cos_m, sin_m = dft.dft_matrices(W)
    ea, es, inv, band = wsola_fast.pitch_corr_matrices(cfg)
    return {
        "hamming": dft.hamming_window(W), "dft_cos": cos_m, "dft_sin": sin_m,
        "cola": wsola_fast._cola_hann(2 * hop),
        "pitch_ea": ea, "pitch_es": es, "pitch_inv": inv, "pitch_band": band,
    }


def device_tables(cfg: SpeedyConfig, device) -> Dict[str, torch.Tensor]:
    """build_tables on `device`, with kernel 1's FFT tables beside them
    (a step given no tables builds them: nine uploads)."""
    tables = {
        k: trace.upload("tables", v, device=device) for k, v in build_tables(cfg).items()
    }
    tables["analysis_fft"] = trace.upload(
        "tables", analysis_fft.packed_table(cfg.window_size), device=device
    )
    return tables


@trace.traced("analysis")
def batched_analysis(
    xs: torch.Tensor,
    cfg: SpeedyConfig,
    num_frames: int,
    gain: Optional[torch.Tensor] = None,
    tables: Optional[Dict[str, torch.Tensor]] = None,
    reference: bool = False,
) -> torch.Tensor:
    """Batched front-end: xs [B, L] -> tension [B, T_out].

    {energy, lsd} per frame come from kernel 1 (kernels.analysis_energy_lsd)
    on the card; the rest is the [B, T] tension chain of ops/analysis.py:
    LPF, √min(2,·), tapered-max hysteresis, the skip gate, the second LPF
    and tension (speedy_tpu/parallel/batch.py:205-270). gain [B] scales each
    utterance after the Hamming window. reference=True uses the kernel's
    plain version on any device.
    """
    B, L = xs.shape
    dt, dev = xs.dtype, xs.device
    T = num_frames
    T_out = cfg.num_tension_frames(T)
    if T_out == 0:
        # Clip shorter than the tension lookahead: no tension frames exist
        # (the shim drains such audio at the requested speed on flush).
        return xs.new_zeros(B, 0)
    if tables is None:
        tables = device_tables(cfg, dev)
    g = torch.ones(B, dtype=dt, device=dev) if gain is None else gain.to(dt).contiguous()
    front = kernels.analysis_energy_lsd_reference if reference else kernels.analysis_energy_lsd
    energy, lsd_full = front(
        xs, g, tables["hamming"], tables["dft_cos"], tables["dft_sin"],
        tables["analysis_fft"], T, cfg.frame_step_int,
    )
    return analysis.tension_chain(energy, lsd_full[:, :T_out], cfg, T_out).tension


def _plan_max_speed(global_speed: float, nonlinear_factor: float) -> float:
    """Planner ceiling on instantaneous speed (the analog of
    min_speed_bound): speeds are clamped to it inside the grid engine.

    The law bounds the requested speed at 1.6*R_g - 0.6 for R_g > 1
    (tension >= -0.6) and at 1.0 for R_g <= 1; +1.0 covers the duration-
    feedback correction. The nonlinear interpolation
    final = req*nl + R_g*(1-nl) can exceed req when nl > 1, so the bound is
    mapped through it. Quantized to 0.5 steps."""
    rg = float(global_speed)
    nl = float(nonlinear_factor)
    req_max = 1.6 * rg - 0.6 + 1.0 if rg > 1.0 else 2.0
    final_max = max(req_max * nl + rg * (1.0 - nl), req_max, rg, 2.0)
    return float(np.ceil(final_max * 2.0) / 2.0)


def _mask_speeds(speeds: torch.Tensor, valid_tension: torch.Tensor) -> torch.Tensor:
    """Hold each utterance's last valid frame's speed through its padded
    tail, mirroring the shim's flush-at-last-speed (soniclib.c:538-551).
    speeds [B, T], valid_tension [B]."""
    idx = torch.arange(speeds.shape[1], device=speeds.device)[None, :]
    last = torch.clamp(valid_tension - 1, min=0)[:, None]
    return torch.where(idx < valid_tension[:, None], speeds, torch.gather(speeds, 1, last))


def _default_min_speed_bound(global_speed: float) -> float:
    return 1.0 if global_speed >= 1.0 else max(C.MIN_SPEED, 0.3 * global_speed)


def grid_output_capacity(
    cfg: SpeedyConfig,
    L: int,
    global_speed: float,
    capacity_factor: Optional[float] = None,
    min_speed_bound: Optional[float] = None,
) -> int:
    """The grid engine's output capacity for a length-L utterance — the
    exact value batched_nonlinear_speedup sizes its output buffer with
    (worst-case plan, or rate-derived when capacity_factor applies)."""
    if min_speed_bound is None:
        min_speed_bound = _default_min_speed_bound(global_speed)
    hop, gcap, _ = wsola_fast.plan_grid(cfg, L, min_speed_bound)
    if capacity_factor is not None and global_speed > 1.0:
        # Quantized to hop multiples, never above the worst-case plan.
        tight = int(np.ceil(capacity_factor * L / global_speed / hop) + 2) * hop
        if tight < gcap:
            gcap = tight
    return gcap


@trace.traced("batch")
def batched_nonlinear_speedup(
    xs: torch.Tensor,
    lengths: torch.Tensor,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    capacity: Optional[int] = None,
    gain: Optional[torch.Tensor] = None,
    capacity_factor: Optional[float] = None,
    tables: Optional[Dict[str, torch.Tensor]] = None,
    period_grid: Optional[torch.Tensor] = None,
    reference: bool = False,
) -> BatchResult:
    """One step: xs [B, L] float32 (±1), lengths [B] -> sped-up audio.

    gain [B]: per-utterance input scale. capacity: output buffer size
    (default: the worst-case plan). capacity_factor (global_speed > 1
    only, ignored when capacity is given): size the output at
    factor * L / global_speed instead; samples past capacity are dropped
    and valid_length then equals capacity exactly. tables: the constant
    tables on xs' device (SpeedupEngine passes its buffers; built from cfg
    when None). period_grid [B, n_grid]: a precomputed pitch grid in place
    of the pitch search. reference=True runs the kernels' plain versions.
    """
    B, L = xs.shape
    dt, dev = xs.dtype, xs.device
    if xs.is_cuda:
        no_tf32()
    xs = xs.contiguous()
    step = cfg.frame_step_int
    W = cfg.window_size
    fut = cfg.hysteresis_future
    T = cfg.num_frames(L, integer_step=True)
    if min_speed_bound is None:
        min_speed_bound = _default_min_speed_bound(global_speed)
    if tables is None:
        tables = device_tables(cfg, dev)
    minp, maxp, _, _ = wsola.plan(cfg, L, min_speed_bound)

    tension = batched_analysis(xs, cfg, T, gain, tables, reference)
    if tension.shape[1] == 0:
        # Entire batch shorter than the tension lookahead: every frame
        # drains at the requested speed (the shim's flush behavior).
        speeds = torch.full((B, 1), float(global_speed), dtype=dt, device=dev)
    elif global_speed > 1.0:
        # Parallel fixed-point form (a contraction only for rg > 1).
        speeds = speed_from_tension_parallel(
            tension, global_speed, duration_feedback_strength, nonlinear_factor
        )
    else:
        speeds, _ = speed_from_tension(
            tension, global_speed, duration_feedback_strength, nonlinear_factor,
            reference=reference,
        )

    lengths = trace.upload("lengths", lengths, dtype=torch.int64, device=dev)
    valid_frames = torch.where(
        lengths >= W, (lengths - W) // step + 1, torch.zeros_like(lengths)
    )
    valid_tension = torch.clamp(
        torch.clamp(valid_frames - fut, min=0), max=speeds.shape[1]
    )
    speeds = _mask_speeds(speeds, valid_tension)
    # Utterances too short for any tension frame run at the global speed.
    rg = trace.upload_once("rg", float(global_speed), dt, dev)
    speeds = torch.where((valid_tension > 0)[:, None], speeds, rg)
    # The planner sizes capacity by min_speed_bound, so speeds are floored
    # there (a no-op for speed-ups, where the law guarantees >= 1).
    speeds = torch.clamp(speeds, min=float(min_speed_bound))

    hop, gcap, K = wsola_fast.plan_grid(cfg, L, min_speed_bound)
    if capacity is not None:
        gcap, K = capacity, capacity // hop + 1
    elif capacity_factor is not None and global_speed > 1.0:
        tight = grid_output_capacity(
            cfg, L, global_speed, capacity_factor, min_speed_bound
        )
        if tight < gcap:
            gcap, K = tight, tight // hop + 1
    corr = tuple(tables[k] for k in ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band"))
    with trace.layer("grid_engine"):
        out = wsola_fast.wsola_grid_batch(
            xs, lengths.to(torch.int32), speeds, minp, maxp, step, hop, gcap, K,
            tables["cola"], corr,
            max_speed_plan=_plan_max_speed(global_speed, nonlinear_factor),
            gain=gain, period_grid=period_grid, reference=reference,
        )
    return BatchResult(out.output, out.valid_length, tension, speeds)


class SpeedupEngine(nn.Module):
    """The batched nonlinear-speedup step for one configuration, with the
    constant tables as buffers on the engine's device.

        engine = SpeedupEngine(SpeedyConfig(16000), 3.5, capacity_factor=1.33)
        engine.to("cuda")
        result = engine(xs, lengths, gain)
    """

    def __init__(
        self,
        cfg: SpeedyConfig,
        global_speed: float,
        nonlinear_factor: float = 1.0,
        duration_feedback_strength: float = 0.1,
        min_speed_bound: Optional[float] = None,
        capacity_factor: Optional[float] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.global_speed = float(global_speed)
        self.nonlinear_factor = float(nonlinear_factor)
        self.duration_feedback_strength = float(duration_feedback_strength)
        self.min_speed_bound = min_speed_bound
        self.capacity_factor = capacity_factor
        for name, tab in device_tables(cfg, "cpu").items():
            self.register_buffer(name, tab)

    def tables(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in TABLE_NAMES + DERIVED_TABLES}

    @torch.no_grad()
    def load_tables(self, arrays: Dict[str, np.ndarray]) -> None:
        """Carry tables across from numpy arrays (e.g. the JAX package's
        own: np.asarray(dft.dft_matrices(W)[0]) for "dft_cos"). Every name
        must be one of TABLE_NAMES and match the buffer's shape; kernel 1's
        FFT tables are derived anew from the window size."""
        for name, arr in arrays.items():
            if name not in TABLE_NAMES:
                raise KeyError(f"unknown table {name!r}; expected one of {TABLE_NAMES}")
            buf = getattr(self, name)
            src = torch.as_tensor(np.asarray(arr, dtype=np.float32))
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(
                    f"table {name!r}: shape {tuple(src.shape)} != {tuple(buf.shape)}"
                )
            buf.copy_(src)
        self.analysis_fft.copy_(
            torch.tensor(analysis_fft.packed_table(self.hamming.shape[0]))
        )

    def forward(
        self,
        xs: torch.Tensor,
        lengths: torch.Tensor,
        gain: Optional[torch.Tensor] = None,
    ) -> BatchResult:
        return batched_nonlinear_speedup(
            xs, lengths, self.cfg, self.global_speed, self.nonlinear_factor,
            self.duration_feedback_strength, self.min_speed_bound,
            gain=gain, capacity_factor=self.capacity_factor,
            tables=self.tables(),
        )
