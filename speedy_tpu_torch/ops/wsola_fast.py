"""Grid-parallel WSOLA (port of speedy_tpu/ops/wsola_fast.py, single-shot).

Four stages, every one parallel over utterances and output chunks:

  1. TIME MAP: per-frame speeds give the output clock o(x) = ∫dx/s(x),
     piecewise linear over analysis frames; inverting it gives each output
     chunk k's nominal source position c_k on the fixed grid k*hop.
  2. PITCH: one sub-sample period per cell of a regular input grid of
     stride G (kernel 2, kernels.pitch_ssd), looked up per chunk.
  3. PHASE SNAP, closed form: a_k = c_k + wrap(c_0 + k*hop - c_k, P_k).
  4. SYNTHESIS: Hann-windowed chunks of width 2*hop gathered at fractional
     a_k, overlap-added on the grid (kernel 3, kernels.gather_synth).

The tables here are built in float64 with numpy and cast once, with the
same recipes as the JAX package, so both packages hold bitwise-equal
tables (tests/test_torch_config.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SpeedyConfig
from . import kernels
from .wsola import WsolaResult


@functools.lru_cache(maxsize=16)
def _cola_hann(width: int, dtype: str = "float32") -> np.ndarray:
    """Offset Hann: w[i] + w[i + width/2] == 1 exactly, w > 0 everywhere."""
    i = np.arange(width, dtype=np.float64) + 0.5
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / width)).astype(dtype)


def _pitch_dft_size(req: int) -> int:
    """Smallest even DFT length M >= req whose real-bin count M//2 + 1 is a
    multiple of 128 (the JAX package's lane alignment; kept so the plain
    pitch search uses the same matrices)."""
    nb = -(-(-(-req // 2) + 1) // 128) * 128
    return 2 * nb - 2


@functools.lru_cache(maxsize=16)
def _pitch_corr_matrices(
    taps: int, seg_w: int, minp: int, maxp: int, M: int, dtype: str = "float32"
):
    """Matrices that turn the pitch SSD into matmuls (the plain version of
    kernel 2 uses them; the kernel sums in the time domain).

    The linear cross-correlation cc[l] = sum_i a0[i]*seg[i+l] (l in
    [minp, maxp]) equals the M-point circular correlation when
    M >= max(seg_w, taps + maxp). Returns (Ea [taps, 2nb], Es [seg_w, 2nb],
    Inv [2nb, n_lags], Band [seg_w, n_lags+1]) with nb = M//2+1:
      FA = a0 @ Ea, FS = seg @ Es               (forward real DFTs)
      cc = [Re(conj(FA)FS) | Im(...)] @ Inv     (inverse DFT at the lags)
      [e_lag | e0] = seg^2 @ Band               (windowed energies)
    """
    assert M >= max(seg_w, taps + maxp)
    nb = M // 2 + 1
    n_lags = maxp - minp + 1
    n = np.arange(M, dtype=np.float64)
    k = np.arange(nb, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / M
    Ea = np.concatenate([np.cos(ang[:taps]), -np.sin(ang[:taps])], axis=1)
    Es = np.concatenate([np.cos(ang[:seg_w]), -np.sin(ang[:seg_w])], axis=1)
    lag = np.arange(minp, maxp + 1, dtype=np.float64)
    angl = 2.0 * np.pi * np.outer(k, lag) / M
    w = np.full((nb, 1), 2.0)
    w[0] = 1.0
    if M % 2 == 0:
        w[-1] = 1.0
    # irfft(Y)[l] = (1/M) sum_k w_k (Re Y[k] cos(2pi k l/M) - Im Y[k] sin(...))
    Inv = np.concatenate([w * np.cos(angl) / M, -w * np.sin(angl) / M], axis=0)
    Band = np.zeros((seg_w, n_lags + 1))
    for j in range(n_lags):
        Band[minp + j : minp + j + taps, j] = 1.0
    Band[:taps, n_lags] = 1.0
    f = np.dtype(dtype).type
    return Ea.astype(f), Es.astype(f), Inv.astype(f), Band.astype(f)


def pitch_corr_matrices(cfg: SpeedyConfig, dtype: str = "float32"):
    """_pitch_corr_matrices at the engine's geometry for cfg (taps =
    max period, window = 2 * max period)."""
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    taps, seg_w = maxp, 2 * maxp
    M = _pitch_dft_size(max(seg_w, taps + maxp))
    return _pitch_corr_matrices(taps, seg_w, minp, maxp, M, dtype)


def _grid_stride(hop: int, max_period: int) -> int:
    """Pitch-grid cell stride G: the smallest multiple of 128 at least
    max(3*hop, seg_w), seg_w = 2*max_period. Seam-critical: streaming
    segments align to it, so wsola_grid_batch and pitch_grid_stride both
    take it from here (speedy_tpu/ops/wsola_fast.py:416, :649-657)."""
    return -(-max(3 * hop, 2 * max_period) // 128) * 128


def default_hop(cfg: SpeedyConfig) -> int:
    """The grid hop: one analysis frame step (10 ms), at least 32 samples."""
    return max(32, cfg.frame_step_int)


def pitch_grid_stride(cfg: SpeedyConfig, hop: Optional[int] = None) -> int:
    """The engine's pitch-grid cell stride G for a given hop."""
    if hop is None:
        hop = default_hop(cfg)
    return _grid_stride(hop, cfg.wsola_max_period)


def plan_grid(
    cfg: SpeedyConfig, input_len: int, min_speed_bound: float, hop: Optional[int] = None
):
    """(hop, capacity, num_chunks) for a length-input_len utterance: one
    frame step per hop (10 ms), capacity for the slowest planned speed,
    rounded to whole 2*hop windows."""
    if hop is None:
        hop = default_hop(cfg)
    capacity = (
        int(np.ceil(input_len / max(min_speed_bound, 0.01))) + 4 * cfg.wsola_max_period
    )
    capacity = -(-capacity // (2 * hop)) * (2 * hop)
    num_chunks = capacity // hop + 1
    return hop, capacity, num_chunks


class GridPositions(NamedTuple):
    a: torch.Tensor      # [B, K] source position of each output chunk
    valid: torch.Tensor  # [B] int32 output length
    cell: torch.Tensor   # [B, K] pitch-grid cell each chunk's period came from
    snap: torch.Tensor   # [B, K] whole periods the phase snap moved each chunk


def grid_positions(
    input_lengths: torch.Tensor,
    speeds: torch.Tensor,
    period_grid: torch.Tensor,
    frame_step: int,
    hop: int,
    grid_stride: int,
    capacity: int,
    num_chunks: int,
    max_speed_plan: Optional[float] = None,
) -> GridPositions:
    """Stages 1 and 3 of the grid engine: input_lengths [B], speeds [B, F]
    and the pitch grid [B, n_grid] of stride grid_stride -> the phase-snapped
    source position of each of num_chunks output chunks on the grid k*hop,
    and each utterance's output length (clamped to capacity)."""
    B = speeds.shape[0]
    dt, dev = speeds.dtype, speeds.device
    K, Hs, G = num_chunks, hop, grid_stride
    n_grid = period_grid.shape[1]
    if max_speed_plan is not None:
        speeds = torch.clamp(speeds, max=float(max_speed_plan))
    n_frames = speeds.shape[1]
    lens = input_lengths.to(torch.int64)
    lens_f = input_lengths.to(dt)

    # ---- 1. time map ----
    inv_s = torch.tensor(float(frame_step), dtype=dt, device=dev) / speeds
    obnd = torch.cat([inv_s.new_zeros(B, 1), torch.cumsum(inv_s, dim=1)], dim=1)
    total_frames = torch.clamp(lens // frame_step, 0, n_frames)
    tail = (lens - total_frames * frame_step).to(dt)
    last_speed = torch.gather(
        speeds, 1, torch.clamp(total_frames, 0, n_frames - 1)[:, None]
    )[:, 0]
    out_len = torch.gather(obnd, 1, total_frames[:, None])[:, 0] + tail / last_speed
    valid = torch.clamp(torch.round(out_len).to(torch.int32), max=capacity)

    p = torch.arange(K, dtype=dt, device=dev) * Hs  # output grid positions [K]
    p_b = p[None, :].expand(B, K).contiguous()
    # Frame f owns output positions [obnd[f], obnd[f+1]); the last frame
    # also owns the tail.
    fidx = torch.searchsorted(obnd[:, 1:].contiguous(), p_b, right=True)
    fidx = torch.clamp(fidx, 0, n_frames - 1)
    sp_f = torch.gather(speeds, 1, fidx)
    ob_f = torch.gather(obnd, 1, fidx)
    c = fidx.to(dt) * frame_step + (p_b - ob_f) * sp_f  # [B, K]
    c = torch.minimum(torch.clamp(c, min=0.0), torch.clamp(lens_f - 1.0, min=0.0)[:, None])

    # ---- 3. phase snap, closed form ----
    g_idx = torch.clamp(torch.round(c / G).to(torch.int64), 0, n_grid - 1)
    period = torch.gather(period_grid, 1, g_idx)  # [B, K]
    kk = torch.arange(K, dtype=dt, device=dev)[None, :]
    delta = c[:, :1] + kk * Hs - c
    snap = torch.round(delta / period)
    o = delta - snap * period
    a = torch.minimum(torch.clamp(c + o, min=0.0), (lens_f - 1.0)[:, None])
    return GridPositions(a, valid, g_idx, snap)


def wsola_grid_batch(
    xs: torch.Tensor,
    input_lengths: torch.Tensor,
    speeds: torch.Tensor,
    min_period: int,
    max_period: int,
    frame_step: int,
    hop: int,
    capacity: int,
    num_chunks: int,
    cola: torch.Tensor,
    corr_mats,
    max_speed_plan: Optional[float] = None,
    gain: Optional[torch.Tensor] = None,
    period_grid: Optional[torch.Tensor] = None,
    reference: bool = False,
) -> WsolaResult:
    """xs [B, L] float32, input_lengths [B], speeds [B, F] -> WsolaResult
    with output [B, capacity] and valid_length [B] (speedy_tpu's
    _wsola_grid_batch, single-shot form).

    cola [2*hop] is _cola_hann(2*hop); corr_mats are the plain pitch
    search's tables. max_speed_plan clamps speeds to the planner's ceiling.
    gain [B] scales each utterance's input. period_grid [B, n_grid]
    (optional) replaces the pitch search; it must come from this G over
    the same xs. reference=True runs the kernels' plain versions on any
    device (for holding the kernels against them on the card).
    """
    B, L = xs.shape
    dt, dev = xs.dtype, xs.device
    maxp, minp = max_period, min_period
    taps = maxp
    gain = torch.ones(B, dtype=dt, device=dev) if gain is None else gain.to(dt)

    # ---- 2. pitch (it reads only xs, so it runs first) ----
    G = _grid_stride(hop, maxp)
    n_grid = -(-(L + taps + maxp) // G)
    if period_grid is None:
        pitch = kernels.pitch_ssd_reference if reference else kernels.pitch_ssd
        period_grid = pitch(xs, gain, taps, minp, maxp, G, n_grid, corr_mats)

    # ---- 1 and 3. time map, phase snap ----
    pos = grid_positions(
        input_lengths, speeds, period_grid, frame_step, hop, G, capacity,
        num_chunks, max_speed_plan,
    )

    # ---- 4. synthesis ----
    a_i = torch.floor(pos.a).to(torch.int32)
    a_f = pos.a - a_i.to(dt)
    synth = kernels.gather_synth_reference if reference else kernels.gather_synth
    out = synth(xs, a_i, a_f, cola, gain, pos.valid, hop, capacity)
    return WsolaResult(
        out, pos.valid, torch.full((B,), num_chunks, dtype=torch.int32, device=dev)
    )
