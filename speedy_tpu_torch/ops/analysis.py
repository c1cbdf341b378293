"""The Speedy analysis front-end: waveform -> per-frame tension and
features (port of speedy_tpu/ops/analysis.py).

The reference's AddData / ComputeTension pipeline (speedy.c:529-766) is
frame-parallel except for two 1-pole lowpass filters (ops/filters.py).
Every function here works along the last axis, on one utterance [L] or a
batch [B, L]. The equivalences the JAX package proves against the C code
hold here unchanged:
  * the preemphasis cross-frame state is a gather (framing.py);
  * `skipped(t) = low_energy(t) or (t == 0)` exactly (speedy.c:685-703,
    293);
  * out-of-range hysteresis reads and the spectrum of frame -1 are zeros;
  * the feature vector of tension frame t mixes AddData-time values of
    frame t + future (columns 1-3, speedy.c:106-109) with tension-time
    values of frame t.

The magnitude spectrogram is torch.matmul against the DFT basis, as the
JAX package leaves it to XLA; no kernel runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import config as C
from .. import trace
from ..config import SpeedyConfig
from . import dft, filters, framing, hysteresis


class AnalysisResult(NamedTuple):
    """With T input frames and T_out = T - hysteresis_future tension frames
    (leading batch axes, if any, first):
      spectrogram:  [T, W+1]  magnitude bins 0..fft/2 per AddData frame
      normalized:   [T_out, W] energy-normalized spectrogram at tension time
      features:     [T_out, 15] the reference's feature vector per tension
                    frame (layout speedy.c:106-124)
      tension:      [T_out]
    """

    spectrogram: torch.Tensor
    normalized: torch.Tensor
    features: torch.Tensor
    tension: torch.Tensor


class TensionChain(NamedTuple):
    """The ComputeTension-time chain (speedy.c:649-766) and the AddData-time
    energies it reads: energy_lp, energy_local and energy_compressed over
    all T frames, the rest over the T_out tension frames."""

    energy_lp: torch.Tensor
    energy_local: torch.Tensor
    energy_compressed: torch.Tensor
    energy_hyst: torch.Tensor
    skipped: torch.Tensor
    lsd: torch.Tensor
    ewld: torch.Tensor
    ew_lpf: torch.Tensor
    rsd: torch.Tensor
    changes: torch.Tensor
    tension: torch.Tensor


def normalize_by_energy(spectrogram: torch.Tensor, eps: float = C.EPS):
    """speedyNormalizeByEnergy (speedy.c:628-647) over the last axis.
    Energy skips the DC bin; the normalization scales every bin (DC too).
    Returns (normalized, signal_energy)."""
    energy = torch.sum(spectrogram[..., 1:] ** 2, dim=-1)
    inv = 1.0 / (torch.sqrt(energy) + eps)
    return spectrogram * inv[..., None], energy


def tension_chain(
    energy: torch.Tensor, lsd: torch.Tensor, cfg: SpeedyConfig, num_out: int
) -> TensionChain:
    """energy [..., T] (bins 1..W-1 of every frame) and the ungated
    log-spectral difference lsd [..., num_out] -> the chain to tension:
    LPF, √min(2,·), tapered-max hysteresis, the skip gate, the second LPF
    (speedy.c:513-520, 649-766)."""
    zero = torch.zeros((), dtype=energy.dtype, device=energy.device)
    energy_lp = filters.first_order_lowpass(
        energy, cfg.lpf_alpha, C.MEAN_SPECTROGRAM_ENERGY
    )
    energy_local = energy / energy_lp
    energy_compressed = torch.sqrt(torch.clamp(energy_local, max=2.0))
    energy_hyst = hysteresis.tapered_max_hysteresis(
        energy_compressed, cfg.hysteresis_future, cfg.hysteresis_past, num_out
    )
    first = torch.arange(num_out, device=energy.device) == 0
    skipped = (energy[..., :num_out] <= cfg.low_energy_threshold) | first
    lsd = torch.where(skipped, zero, lsd)
    ewld = lsd * energy_hyst  # zero when skipped, since lsd is
    ew_lpf = filters.first_order_lowpass(
        torch.where(skipped, zero, ewld),
        cfg.lpf_alpha,
        C.MEAN_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE,
    )
    rsd = torch.where(skipped, zero, ewld / (ew_lpf + 0.01 * C.MEAN_EMPHASIS_WEIGHTED_LPF))
    changes = torch.where(skipped, zero, torch.clamp(rsd, max=cfg.speech_changes_clamp))
    tension = C.TENSION_A * (energy_hyst - C.TENSION_M_E) + C.TENSION_B * (
        changes - C.TENSION_M_S
    )
    return TensionChain(
        energy_lp, energy_local, energy_compressed, energy_hyst, skipped, lsd,
        ewld, ew_lpf, rsd, changes, tension,
    )


@trace.traced("analysis")
def analyze(
    x: torch.Tensor,
    cfg: SpeedyConfig,
    num_frames: Optional[int] = None,
    integer_step: bool = False,
) -> AnalysisResult:
    """Full analysis of x [..., L] (float32, nominal range ±1), on x's
    device.

    num_frames defaults to the reference harness's count for L; pass it
    when x is padded so that padding frames are simply computed (their
    outputs are garbage for the caller to mask)."""
    dt, dev = x.dtype, x.device
    if x.is_cuda:
        dft.no_tf32()
    W = cfg.window_size
    fut = cfg.hysteresis_future
    if num_frames is None:
        num_frames = cfg.num_frames(x.shape[-1], integer_step)
    T = num_frames
    T_out = cfg.num_tension_frames(T)
    lead = x.shape[:-1]
    if T == 0:
        # Shorter than one analysis window: no frames, no tension (the
        # reference never returns data, speedy.c:752-765).
        return AnalysisResult(
            x.new_zeros(lead + (0, W + 1)),
            x.new_zeros(lead + (0, W)),
            x.new_zeros(lead + (0, C.FEATURE_COUNT)),
            x.new_zeros(lead + (0,)),
        )

    starts = trace.upload(
        "frame_starts", framing.frame_starts(cfg, T, integer_step), device=dev
    )
    frames = framing.extract_frames(x, starts, W)
    pre = framing.preemphasize(frames, framing.preemphasis_state(x, starts, W))

    # ---- AddData-time chain (speedy.c:540-551) ----
    spec = dft.magnitude_spectrogram(pre, cfg)  # [..., T, W+1]
    half = spec[..., :W]  # bins 0..fft/2-1, all any consumer reads
    energy = torch.sum(half[..., 1:] ** 2, dim=-1)  # speedy.c:513-516

    # ---- ComputeTension-time chain for t < T_out (speedy.c:649-766) ----
    cur = half[..., :T_out, :]
    # Frame t-1, zeros for t = 0. With T_out = 0 there is no frame t at all
    # (the JAX package's [:T_out - 1] would wrap to [:-1] there).
    last = torch.cat(
        [half.new_zeros(lead + (1, W)), half[..., : max(T_out - 1, 0), :]], dim=-2
    )[..., :T_out, :]
    normalized, sig_energy = normalize_by_energy(cur)
    normalized_last, _ = normalize_by_energy(last)
    # 40 dB bin mask (speedy.c:705-719); DC excluded from both max and sum.
    bin_thresh = torch.amax(cur[..., 1:], dim=-1, keepdim=True) / 100.0
    mask = (cur[..., 1:] > bin_thresh) & (last[..., 1:] > bin_thresh)
    eps = trace.upload("eps", C.EPS, dtype=dt, device=dev)
    log_ratio = torch.abs(
        torch.log((normalized[..., 1:] + eps) / (normalized_last[..., 1:] + eps))
    )
    lsd = torch.where(mask, log_ratio, torch.zeros((), dtype=dt, device=dev)).sum(-1)
    ch = tension_chain(energy, lsd, cfg, T_out)

    # ---- Feature vector (layout speedy.c:106-124; timing per docstring) ----
    t_idx = torch.arange(T_out, dtype=dt, device=dev).expand(lead + (T_out,))
    ahead = slice(fut, fut + T_out)
    feats = torch.stack(
        [
            sig_energy,                           # 0 spectrogram_energy (t)
            ch.energy_lp[..., ahead],             # 1 energy_lp (t+future)
            ch.energy_local[..., ahead],          # 2 energy_local (t+future)
            ch.energy_compressed[..., ahead],     # 3 energy_compressed (t+future)
            ch.energy_hyst,                       # 4
            ch.skipped.to(dt),                    # 5 low_energy_frame
            ch.lsd,                               # 6
            ch.ewld,                              # 7
            ch.ew_lpf,                            # 8
            ch.rsd,                               # 9
            ch.changes,                           # 10
            ch.tension,                           # 11
            t_idx + fut,                          # 12 time_energy
            t_idx,                                # 13 time_spectral
            torch.full_like(t_idx, cfg.low_energy_threshold),  # 14
        ],
        dim=-1,
    )
    return AnalysisResult(spec, normalized, feats, ch.tension)


def analyze_batch(
    x: torch.Tensor, cfg: SpeedyConfig, num_frames: int, integer_step: bool = False
) -> AnalysisResult:
    """analyze over a batch of equal-padded utterances x [B, L] with a
    common frame count (the JAX package's vmap of analyze)."""
    return analyze(x, cfg, num_frames, integer_step)
