"""Grid-parallel WSOLA (port of speedy_tpu/ops/wsola_fast.py, single-shot).

Four stages, every one parallel over utterances and output chunks:

  1. TIME MAP: per-frame speeds give the output clock o(x) = ∫dx/s(x),
     piecewise linear over analysis frames; inverting it gives each output
     chunk k's nominal source position c_k on the fixed grid k*hop.
  2. PITCH: one sub-sample period per cell of a regular input grid of
     stride G (kernel 2, kernels.pitch_ssd), looked up per chunk.
  3. PHASE SNAP, closed form: a_k = c_k + wrap(c_0 + k*hop - c_k, P_k).
  4. SYNTHESIS: Hann-windowed chunks of width 2*hop gathered at fractional
     a_k, overlap-added on the grid. With a planner ceiling on speed
     (max_speed_plan) one kernel does all of it (kernel 3,
     kernels.gather_synth); without one, as from time_scale_grid, the
     chunks' rows are gathered by kernel 4 (kernels.gather_rows) and
     interpolated, windowed and overlap-added in torch, as the JAX
     package's per-row route does. The JAX package's route for a ceiling
     off the TPU, the block-span gather (kernel 5,
     kernels.gather_rows_block) with the same torch steps, is
     _synth_spans; no engine calls it.

The tables here are built in float64 with numpy and cast once, with the
same recipes as the JAX package, so both packages hold bitwise-equal
tables (tests/test_torch_config.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..config import SpeedyConfig
from . import kernels
from .dft import no_tf32
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
    inv_s = trace.upload_once("frame_step", float(frame_step), dt, dev) / speeds
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
    search's tables. max_speed_plan clamps speeds to the planner's ceiling
    and selects the fused synthesis (kernel 3); None selects the per-row
    gather (kernel 4). gain [B] scales each utterance's input.
    period_grid [B, n_grid] (optional) replaces the pitch search; it must
    come from this G over the same xs. reference=True runs the kernels'
    plain versions on any device (for holding the kernels against them on
    the card).
    """
    B, L = xs.shape
    dt, dev = xs.dtype, xs.device
    maxp, minp = max_period, min_period
    taps = maxp
    g = torch.ones(B, dtype=dt, device=dev) if gain is None else gain.to(dt)

    # ---- 2. pitch (it reads only xs, so it runs first) ----
    G = _grid_stride(hop, maxp)
    n_grid = -(-(L + taps + maxp) // G)
    if period_grid is None:
        pitch = kernels.pitch_ssd_reference if reference else kernels.pitch_ssd
        period_grid = pitch(xs, g, taps, minp, maxp, G, n_grid, corr_mats)

    # ---- 1 and 3. time map, phase snap ----
    pos = grid_positions(
        input_lengths, speeds, period_grid, frame_step, hop, G, capacity,
        num_chunks, max_speed_plan,
    )

    # ---- 4. synthesis ----
    a_i = torch.floor(pos.a).to(torch.int32)
    a_f = pos.a - a_i.to(dt)
    if max_speed_plan is None:
        out = _synth_per_row(
            xs, a_i, a_f, cola, gain, pos.valid, hop, capacity, maxp, reference
        )
    else:
        synth = kernels.gather_synth_reference if reference else kernels.gather_synth
        out = synth(xs, a_i, a_f, cola, g, pos.valid, hop, capacity)
    return WsolaResult(
        out, pos.valid, torch.full((B,), num_chunks, dtype=torch.int32, device=dev)
    )


def _synth_source(xs, gain, valid, hop, num_chunks, max_period):
    """The unfused routes' gather inputs (speedy_tpu/ops/wsola_fast.py:
    593-601): the gain-scaled source padded by max_period in front and
    2*max_period + taps + 2*hop behind (taps = max_period), and the rows
    that reach the valid output, valid // hop + 2 (at most num_chunks)."""
    src = xs if gain is None else xs * gain.to(xs.dtype)[:, None]
    src_pad = torch.nn.functional.pad(src, (max_period, 3 * max_period + 2 * hop))
    valid_rows = torch.clamp(valid // hop + 2, max=num_chunks).to(torch.int32)
    return src_pad, valid_rows


def _overlap_add(wide, a_f, win, valid, hop, capacity):
    """Rows wide [B, K, 2*hop + 1] gathered at the chunks' integer positions
    -> [B, capacity]: linear interpolation by a_f, the COLA window, the
    half-slot overlap-add with slot 0 unwindowed, and the valid-length mask
    (speedy_tpu/ops/wsola_fast.py:613-626, shared by both unfused routes)."""
    B, K = a_f.shape
    af = a_f[:, :, None]
    raw = wide[:, :, :-1] * (1.0 - af) + wide[:, :, 1:] * af
    rows = raw * win
    slots = torch.cat([raw[:, :1, :hop], rows[:, 1:, :hop] + rows[:, :-1, hop:]], dim=1)
    out = slots.reshape(B, K * hop)[:, :capacity]
    keep = torch.arange(capacity, device=wide.device)[None, :] < valid[:, None]
    return torch.where(keep, out, torch.zeros((), dtype=wide.dtype, device=wide.device))


def _synth_per_row(
    xs: torch.Tensor,
    a_i: torch.Tensor,
    a_f: torch.Tensor,
    win: torch.Tensor,
    gain: Optional[torch.Tensor],
    valid: torch.Tensor,
    hop: int,
    capacity: int,
    max_period: int,
    reference: bool,
) -> torch.Tensor:
    """Synthesis without a speed ceiling (speedy_tpu/ops/wsola_fast.py:
    602-605): rows of 2*hop + 1 samples gathered one by one (kernel 4) from
    the padded source for the chunks that reach the valid output, then
    _overlap_add. Returns [B, capacity]."""
    src_pad, valid_rows = _synth_source(xs, gain, valid, hop, a_i.shape[1], max_period)
    gather = kernels.gather_rows_reference if reference else kernels.gather_rows
    wide = gather(src_pad, a_i + max_period, 2 * hop + 1, valid_rows)
    return _overlap_add(wide, a_f, win, valid, hop, capacity)


# Rows a block of the block-span gather: the JAX engine's span_rows
# (speedy_tpu/ops/wsola_fast.py:283-288).
SPAN_ROWS = 128


def span_width(
    span_rows: int, hop: int, max_speed_plan: float, max_period: int, width: int
) -> int:
    """The block-span gather's w_span under a speed ceiling
    (speedy_tpu/ops/wsola_fast.py:547-553): span_rows - 1 chunk steps of at
    most ceil(hop * max_speed_plan) samples, the phase snap's max_period,
    one row of width and 32 samples of slack, rounded up to 1024."""
    need = (span_rows - 1) * int(np.ceil(hop * max_speed_plan)) + max_period + width + 32
    return -(-need // 1024) * 1024


def _synth_spans(
    xs: torch.Tensor,
    a_i: torch.Tensor,
    a_f: torch.Tensor,
    win: torch.Tensor,
    gain: Optional[torch.Tensor],
    valid: torch.Tensor,
    hop: int,
    capacity: int,
    max_period: int,
    max_speed_plan: float,
) -> torch.Tensor:
    """Synthesis through the block-span gather: the JAX package's route for
    a speed ceiling off the TPU (speedy_tpu/ops/wsola_fast.py:606-626),
    with SPAN_ROWS rows a block and w_span planned from the ceiling
    (span_width). Its gather is kernel 5 (kernels.gather_rows_block, the
    counterpart of speedy_tpu/ops/wsola_fast.py:149-252's
    _gather_rows_spans), whose rows past valid_rows are zeros whatever the
    starts' spread. The port's engines take kernel 3 for a ceiling, as the
    TPU does; this route serves the tests and the smoke run. Returns
    [B, capacity]."""
    width = 2 * hop + 1
    w_span = span_width(SPAN_ROWS, hop, max_speed_plan, max_period, width)
    src_pad, valid_rows = _synth_source(xs, gain, valid, hop, a_i.shape[1], max_period)
    wide = kernels.gather_rows_block(
        src_pad, a_i + max_period, width, SPAN_ROWS, w_span, valid_rows)
    return _overlap_add(wide, a_f, win, valid, hop, capacity)


@trace.traced("grid_engine")
def time_scale_grid(
    x,
    speeds,
    cfg: SpeedyConfig,
    input_length: Optional[int] = None,
    min_speed_bound: float = 0.25,
    hop: Optional[int] = None,
    capacity: Optional[int] = None,
    max_speed_bound: Optional[float] = None,
    *,
    device="cuda",
    period_grid: Optional[torch.Tensor] = None,
    reference: bool = False,
) -> WsolaResult:
    """Grid-parallel time-scaling of one mono utterance x [L] (float32, a
    tensor or an array) at per-frame speeds [F], on `device` (the card
    unless the caller asks for the CPU; without a card, "cuda" raises).

    max_speed_bound: optional planner ceiling on instantaneous speed
    (speeds are clamped to it); selects the fused synthesis (kernel 3).
    None keeps speeds unbounded and synthesis per row (kernel 4).
    period_grid [n_grid] (optional) replaces the pitch search (see
    wsola_grid_batch); reference=True runs the kernels' plain versions.
    Returns WsolaResult with output [capacity] and 0-dim valid_length."""
    dev = kernels.resolve_device(device)
    if dev.type == "cuda":
        no_tf32()
    x = trace.upload("grid_input", x, dtype=torch.float32, device=dev).contiguous()
    L = x.shape[-1]
    if input_length is None:
        input_length = L
    h, cap, K = plan_grid(cfg, L, min_speed_bound, hop)
    if capacity is not None:
        cap, K = capacity, capacity // h + 1
    res = wsola_grid_batch(
        x[None, :],
        trace.upload("input_length", [input_length], dtype=torch.int32, device=dev),
        trace.upload("grid_speeds", speeds, dtype=torch.float32, device=dev).reshape(1, -1),
        cfg.wsola_min_period,
        cfg.wsola_max_period,
        cfg.frame_step_int,
        h,
        cap,
        K,
        trace.upload("cola", _cola_hann(2 * h), device=dev),
        tuple(trace.upload("pitch_tables", m, device=dev) for m in pitch_corr_matrices(cfg)),
        max_speed_plan=max_speed_bound,
        period_grid=None if period_grid is None else period_grid.reshape(1, -1),
        reference=reference,
    )
    return WsolaResult(res.output[0], res.valid_length[0], res.steps_used[0])
