"""The plain reference of speedy's nonlinear speedup, for judging the port.

Plain PyTorch and NumPy, float32, written from the algorithm's definition
(google/speedy speedy.c:416-788, soniclib.c:240-373) and the grid WSOLA of
the repository's JAX package, and independent of the program under test:
it imports nothing of `speedy_tpu_torch`, `speedy_tpu` or JAX, builds its
own tables (Hamming window, DFT basis, COLA window, pitch matrices) and
works out again everything the program derives (frame counts, capacity,
the slowest speed, the pitch grid, the chunk positions, lengths).

Where the program has a faster form, this file keeps the plain one:
  * the spectrum is a product with the [W, W+1] DFT basis;
  * both lowpass filters and the speed law walk the frames one by one, as
    speedy.c does (the program's batch path solves the law by a parallel
    fixed-point iteration);
  * the pitch search is the SSD by real-DFT products over a grid of cells;
  * synthesis gathers each chunk, interpolates, windows and overlap-adds.

Every product goes through Plain.mm. With tf32=True its operands are first
rounded to TF32's 10-bit mantissa: that is the control, the reference
computed in the precision just below the configuration's (float32 with
TF32 off), which the comparison must refuse.

Spectra, pitch and synthesis run on `device` in blocks of rows; the
frame-sequential parts (filters, hysteresis, law, time map) on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

FRAME_RATE_HZ = 100.0
MIN_SPEED = 0.01
PREEMPHASIS = 0.97
EPS = 2.2204e-16
MEAN_SPECTROGRAM_ENERGY = 2.14204
MEAN_EW_LOCAL_DIFFERENCE = 123.837
MEAN_EW_LPF = 123.979
MEAN_RELATIVE_SPECTRAL_DIFFERENCE = 0.971975
MAX_ENERGY_HYSTERESIS = 1.41421
TENSION_A, TENSION_B, TENSION_M_E, TENSION_M_S = 0.5, 0.25, 0.7, 1.0
MIN_PITCH_HZ, MAX_PITCH_HZ = 65, 400
HYSTERESIS_FUTURE, HYSTERESIS_PAST = 8, 12  # speedy.h:136-146, Matlab mode
ROWS_PER_BLOCK = 256     # rows of one block of spectra, pitch or synthesis
CELLS_PER_BLOCK = 16384  # pitch cells of one product


class Result(NamedTuple):
    tension: torch.Tensor  # [n, T_out] float32, CPU
    speeds: torch.Tensor   # [n, F] float32, CPU
    output: torch.Tensor   # [n, capacity] float32, on the reference's device
    valid: torch.Tensor    # [n] int64, CPU


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x float32 rounded to nearest (ties to even) at TF32's 10-bit
    mantissa, as the tensor cores read a float32 operand with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Geometry:
    """Every size the algorithm derives from the sample rate."""

    def __init__(self, sample_rate: int):
        sr = int(sample_rate)
        self.sample_rate = sr
        self.window = int(1.5 * sr / FRAME_RATE_HZ)          # speedy.c:213
        self.step = sr // int(FRAME_RATE_HZ)                  # speedy.c:335
        self.alpha = math.exp(-1.0 / FRAME_RATE_HZ)           # speedy.c:287-292
        self.low_energy = 0.04 * MAX_ENERGY_HYSTERESIS        # speedy.c:682
        self.changes_clamp = 4.0 * MEAN_RELATIVE_SPECTRAL_DIFFERENCE
        self.min_period = sr // MAX_PITCH_HZ
        self.max_period = sr // MIN_PITCH_HZ
        self.hop = max(32, self.step)
        self.grid_stride = -(-max(3 * self.hop, 2 * self.max_period) // 128) * 128

    def frames(self, L: int) -> int:
        return 0 if L < self.window else (L - self.window) // self.step + 1

    def tension_frames(self, L: int) -> int:
        return max(0, self.frames(L) - HYSTERESIS_FUTURE)

    def capacity(self, L: int, min_speed: float) -> int:
        """Output samples planned for the slowest speed, in whole 2*hop."""
        cap = int(np.ceil(L / max(min_speed, MIN_SPEED))) + 4 * self.max_period
        return -(-cap // (2 * self.hop)) * (2 * self.hop)


def _pitch_tables(g: Geometry):
    """(Ea, Es, Inv, Band) turning the pitch SSD of a cell into products:
    real DFTs of the template and the segment, the inverse DFT at each lag,
    and the windowed energies. M is the smallest even length >= 2*max_period
    whose bin count is a multiple of 128."""
    taps, seg_w, minp, maxp = g.max_period, 2 * g.max_period, g.min_period, g.max_period
    nb = -(-(-(-seg_w // 2) + 1) // 128) * 128
    M = 2 * nb - 2
    n = np.arange(M, dtype=np.float64)
    k = np.arange(nb, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / M
    Ea = np.concatenate([np.cos(ang[:taps]), -np.sin(ang[:taps])], axis=1)
    Es = np.concatenate([np.cos(ang[:seg_w]), -np.sin(ang[:seg_w])], axis=1)
    lag = np.arange(minp, maxp + 1, dtype=np.float64)
    angl = 2.0 * np.pi * np.outer(k, lag) / M
    w = np.full((nb, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    Inv = np.concatenate([w * np.cos(angl) / M, -w * np.sin(angl) / M], axis=0)
    n_lags = maxp - minp + 1
    Band = np.zeros((seg_w, n_lags + 1))
    for j in range(n_lags):
        Band[minp + j: minp + j + taps, j] = 1.0
    Band[:taps, n_lags] = 1.0
    return tuple(t.astype(np.float32) for t in (Ea, Es, Inv, Band))


class Plain:
    """The reference for one sample rate on one device."""

    def __init__(self, sample_rate: int, device="cpu", tf32: bool = False):
        self.g = g = Geometry(sample_rate)
        self.device = torch.device(device)
        # Full float32 products on the card (TF32 only by round_tf32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.tf32 = tf32
        W = g.window
        i = np.arange(W, dtype=np.float64)
        n = i[:, None]
        k = np.arange(W + 1, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * k * n / (2.0 * W)
        cola = np.arange(2 * g.hop, dtype=np.float64) + 0.5
        tables = {
            "hamming": 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (W - 1.0)),
            "cos": np.cos(ang), "sin": -np.sin(ang),
            "cola": 0.5 - 0.5 * np.cos(2.0 * np.pi * cola / (2 * g.hop)),
        }
        self.t = {k: torch.tensor(v.astype(np.float32), device=self.device)
                  for k, v in tables.items()}
        self.pitch = tuple(torch.tensor(m, device=self.device) for m in _pitch_tables(g))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    # ---- analysis ----

    def spectra(self, x: torch.Tensor, gain: Optional[torch.Tensor], T: int):
        """x [n, L] -> (energy [n, T], lsd [n, T]) on the CPU: pre-emphasis
        carrying the previous frame's last raw sample, the Hamming window,
        the gain, |DFT| of the frame zero-padded to 2W (bins 0..W-1), the
        energy of bins 1..W-1 and the masked log-spectral difference
        against the frame before (speedy.c:416-474, 513-520, 628-719)."""
        W, step = self.g.window, self.g.step
        n = x.shape[0]
        frames = x.unfold(1, W, step)[:, :T]
        prev_last = x[:, torch.arange(T - 1, device=x.device) * step + (W - 1)]
        state = torch.cat([x.new_zeros(n, 1), prev_last], dim=1)
        prev = torch.cat([state[:, :, None], frames[:, :, :-1]], dim=2)
        fw = (frames - torch.tensor(PREEMPHASIS, device=x.device) * prev) * self.t["hamming"]
        if gain is not None:
            fw = fw * gain[:, None, None]
        re = self.mm(fw, self.t["cos"])
        im = self.mm(fw, self.t["sin"])
        mag = torch.sqrt(re * re + im * im)[:, :, :W]
        energy = (mag[:, :, 1:] * mag[:, :, 1:]).sum(-1)
        eps = torch.tensor(EPS, device=x.device)
        last = torch.cat([mag.new_zeros(n, 1, W), mag[:, :-1]], dim=1)
        last_energy = torch.cat([energy.new_zeros(n, 1), energy[:, :-1]], dim=1)
        norm = mag / (torch.sqrt(energy)[..., None] + eps)
        norm_last = last / (torch.sqrt(last_energy)[..., None] + eps)
        thresh = mag[:, :, 1:].amax(dim=-1, keepdim=True) / 100.0
        mask = (mag[:, :, 1:] > thresh) & (last[:, :, 1:] > thresh)
        ratio = torch.abs(torch.log((norm[:, :, 1:] + eps) / (norm_last[:, :, 1:] + eps)))
        lsd = torch.where(mask, ratio, torch.zeros((), device=x.device)).sum(-1)
        return energy.cpu(), lsd.cpu()

    def _lowpass(self, x: torch.Tensor, initial: float) -> torch.Tensor:
        """y[t] = a*y[t-1] + (1-a)*x[t], y[-1] = initial (speedy.c:73-84)."""
        a = torch.tensor(self.g.alpha, dtype=torch.float32)
        b = 1.0 - a
        y = torch.full((x.shape[0],), initial, dtype=torch.float32)
        out = torch.empty_like(x)
        for t in range(x.shape[1]):
            y = a * y + b * x[:, t]
            out[:, t] = y
        return out

    def tension(self, energy: torch.Tensor, lsd: torch.Tensor, T_out: int) -> torch.Tensor:
        """The ComputeTension chain (speedy.c:649-766) -> [n, T_out]."""
        g = self.g
        zero = torch.zeros(())
        energy_lp = self._lowpass(energy, MEAN_SPECTROGRAM_ENERGY)
        compressed = torch.sqrt(torch.clamp(energy / energy_lp, max=2.0))
        n, T = compressed.shape
        fut = torch.zeros(n, T_out)
        past = torch.zeros(n, T_out)
        # The tapered maxima of speedy.c:587-619; reads outside [0, T) are 0.
        P, F = HYSTERESIS_PAST, HYSTERESIS_FUTURE
        padded = torch.nn.functional.pad(compressed, (P, F))
        for i in range(F + 1):
            fut = torch.maximum(fut, padded[:, P + i: P + i + T_out] * ((F - i) / float(F)))
        for i in range(P + 1):
            past = torch.maximum(past, padded[:, P - i: P - i + T_out] * ((P - i) / float(P)))
        hyst = (past + fut) / 2.0
        skipped = energy[:, :T_out] <= g.low_energy
        skipped[:, 0] = True
        lsd = torch.where(skipped, zero, lsd[:, :T_out])
        ewld = lsd * hyst
        ew_lpf = self._lowpass(torch.where(skipped, zero, ewld), MEAN_EW_LOCAL_DIFFERENCE)
        rsd = torch.where(skipped, zero, ewld / (ew_lpf + 0.01 * MEAN_EW_LPF))
        changes = torch.where(skipped, zero, torch.clamp(rsd, max=g.changes_clamp))
        return (TENSION_A * (hyst - TENSION_M_E)
                + TENSION_B * (changes - TENSION_M_S))

    # ---- speed law ----

    @staticmethod
    def speed_law(tension: torch.Tensor, rate: float, fb: float, nl: float) -> torch.Tensor:
        """speedyComputeSpeedFromTension (speedy.c:768-788) frame by frame
        with duration feedback, then the shim's nonlinear interpolation
        (soniclib.c:342-345); float32 throughout. [n, T] -> [n, T]."""
        f = np.float32
        rg, fbk, nlf, ms, fd, one = f(rate), f(fb), f(nl), f(MIN_SPEED), f(1.0 / FRAME_RATE_HZ), f(1.0)
        t_all = tension.numpy().astype(np.float32)
        n, T = t_all.shape
        cur = np.zeros(n, np.float32)
        des = np.zeros(n, np.float32)
        out = np.empty((n, T), np.float32)
        for i in range(T):
            t = t_all[:, i]
            if rg > one:
                base = np.maximum(rg + (one - rg) * t, one)
            else:
                base = np.maximum(ms, np.minimum(rg - (one - rg) * t, one))
            req = base + np.maximum(ms, fbk * (cur - des)) if fbk > 0 else base
            cur = cur + fd / req
            des = des + fd / rg
            out[:, i] = req * nlf + rg * (one - nlf)
        return torch.from_numpy(out)

    # ---- grid WSOLA ----

    def pitch_grid(self, x: torch.Tensor, gain: torch.Tensor, n_grid: int) -> torch.Tensor:
        """x [n, L] on device -> period [n, n_grid]: per cell of stride G, the
        lag in [min_period, max_period] of least SSD between the first
        max_period samples and the segment at that lag, refined by a
        parabola through its neighbours (clipped to half a sample)."""
        g = self.g
        n, L = x.shape
        G, taps, minp = g.grid_stride, g.max_period, g.min_period
        seg_w = 2 * g.max_period
        nl = g.max_period - minp + 1
        Ea, Es, Inv, Band = self.pitch
        nb = Ea.shape[1] // 2
        xg = torch.nn.functional.pad(x * gain[:, None], (0, n_grid * G - L))
        seg = xg.reshape(n, n_grid, G)[:, :, :seg_w]
        per = max(1, CELLS_PER_BLOCK // max(n, 1))
        out = []
        for c0 in range(0, n_grid, per):
            s = seg[:, c0: c0 + per]
            FA = self.mm(s[..., :taps], Ea)
            FS = self.mm(s, Es)
            AR, AI, SR, SI = FA[..., :nb], FA[..., nb:], FS[..., :nb], FS[..., nb:]
            cc = self.mm(AR * SR + AI * SI, Inv[:nb]) + self.mm(AR * SI - AI * SR, Inv[nb:])
            E = self.mm(s * s, Band)
            ssd = E[..., nl:] + E[..., :nl] - 2.0 * cc
            jc = torch.argmin(ssd, dim=-1).clamp(1, nl - 2)
            take = lambda off: torch.gather(ssd, -1, (jc + off)[..., None])[..., 0]
            l, m, r = take(-1), take(0), take(1)
            den = l - 2.0 * m + r
            frac = torch.where(torch.abs(den) > 1e-12, 0.5 * (l - r) / den,
                               torch.zeros_like(den))
            out.append((minp + jc).to(torch.float32) + frac.clamp(-0.5, 0.5))
        return torch.cat(out, dim=1)

    def positions(self, lengths, speeds, period, capacity: int, max_speed=None):
        """The time map (output clock o = integral of dx/s over frames), each
        output chunk k's source position c_k at k*hop, the phase snap
        a_k = c_k + wrap(c_0 + k*hop - c_k, P_k), and the output length.
        All on speeds' device; returns (a [n, K], valid [n] int32)."""
        g = self.g
        n, F = speeds.shape
        dev = speeds.device
        K, hop, G, step = capacity // g.hop + 1, g.hop, g.grid_stride, g.step
        if max_speed is not None:
            speeds = torch.clamp(speeds, max=float(max_speed))
        lens = lengths.to(device=dev, dtype=torch.int64)
        lens_f = lens.to(torch.float32)
        inv = torch.tensor(float(step), device=dev) / speeds
        obnd = torch.cat([inv.new_zeros(n, 1), torch.cumsum(inv, dim=1)], dim=1)
        total = torch.clamp(lens // step, 0, F)
        tail = (lens - total * step).to(torch.float32)
        last = torch.gather(speeds, 1, torch.clamp(total, 0, F - 1)[:, None])[:, 0]
        out_len = torch.gather(obnd, 1, total[:, None])[:, 0] + tail / last
        valid = torch.clamp(torch.round(out_len).to(torch.int32), max=capacity)
        p = (torch.arange(K, dtype=torch.float32, device=dev) * hop)[None].expand(n, K).contiguous()
        fidx = torch.clamp(torch.searchsorted(obnd[:, 1:].contiguous(), p, right=True), 0, F - 1)
        c = fidx.to(torch.float32) * step + (p - torch.gather(obnd, 1, fidx)) * torch.gather(speeds, 1, fidx)
        c = torch.minimum(torch.clamp(c, min=0.0), torch.clamp(lens_f - 1.0, min=0.0)[:, None])
        cell = torch.clamp(torch.round(c / G).to(torch.int64), 0, period.shape[1] - 1)
        P = torch.gather(period, 1, cell)
        kk = torch.arange(K, dtype=torch.float32, device=dev)[None, :]
        delta = c[:, :1] + kk * hop - c
        a = c + (delta - torch.round(delta / P) * P)
        a = torch.minimum(torch.clamp(a, min=0.0), (lens_f - 1.0)[:, None])
        return a, valid

    def synthesize(self, x, a, gain, valid, capacity: int) -> torch.Tensor:
        """Chunks of 2*hop + 1 samples read at floor(a_k), interpolated by
        a_k's fraction, COLA-windowed and overlap-added on the grid k*hop
        (slot 0 unwindowed), times the gain, zero from valid on."""
        n, L = x.shape
        hop = self.g.hop
        K = a.shape[1]
        a_i = torch.floor(a).to(torch.int64)
        a_f = (a - a_i.to(torch.float32))[:, :, None]
        idx = a_i[:, :, None] + torch.arange(2 * hop + 1, device=x.device)
        wide = torch.gather(x, 1, idx.clamp(0, L - 1).reshape(n, -1)).reshape(idx.shape)
        wide = torch.where((idx >= 0) & (idx < L), wide, torch.zeros((), device=x.device))
        raw = wide[:, :, :-1] * (1.0 - a_f) + wide[:, :, 1:] * a_f
        rows = raw * self.t["cola"]
        slots = torch.cat([raw[:, :1, :hop], rows[:, 1:, :hop] + rows[:, :-1, hop:]], dim=1)
        out = slots.reshape(n, K * hop)[:, :capacity] * gain[:, None]
        keep = torch.arange(capacity, device=x.device)[None, :] < valid[:, None]
        return torch.where(keep, out, torch.zeros((), device=x.device))

    def wsola(self, x, lengths, speeds, gain, capacity: int, max_speed=None) -> tuple:
        """Blocks of rows through pitch, positions and synthesis on the
        device -> (output [n, capacity] on the device, valid [n] on the
        CPU)."""
        g = self.g
        n, L = x.shape
        n_grid = -(-(L + 2 * g.max_period) // g.grid_stride)
        outs, valids = [], []
        for r0 in range(0, n, ROWS_PER_BLOCK):
            sl = slice(r0, r0 + ROWS_PER_BLOCK)
            xb = x[sl].to(self.device)
            gb = gain[sl].to(self.device)
            period = self.pitch_grid(xb, gb, n_grid)
            a, valid = self.positions(lengths[sl].to(self.device),
                                      speeds[sl].to(self.device), period, capacity, max_speed)
            outs.append(self.synthesize(xb, a, gb, valid, capacity))
            valids.append(valid.cpu())
        return torch.cat(outs), torch.cat(valids).to(torch.int64)

    def analysis(self, x: torch.Tensor, gain: Optional[torch.Tensor]) -> torch.Tensor:
        """x [n, L] (any device) -> tension [n, T_out] on the CPU."""
        n, L = x.shape
        T, T_out = self.g.frames(L), self.g.tension_frames(L)
        parts = [self.spectra(x[r: r + ROWS_PER_BLOCK].to(self.device),
                              None if gain is None else gain[r: r + ROWS_PER_BLOCK].to(self.device), T)
                 for r in range(0, n, ROWS_PER_BLOCK)]
        energy = torch.cat([p[0] for p in parts])
        lsd = torch.cat([p[1] for p in parts])
        return self.tension(energy, lsd, T_out)

    # ---- the two entries ----

    def batch(self, xs, gain, rate: float, nl: float, fb: float, capacity_factor) -> Result:
        """SpeedupEngine.forward's contract for rows xs [n, L] of full
        length: speeds floored at 1 (rate >= 1) and capped at the planner's
        ceiling, capacity from capacity_factor * L / rate."""
        g = self.g
        n, L = xs.shape
        tension = self.analysis(xs, gain)
        speeds = self.speed_law(tension, rate, fb, nl)
        min_speed = 1.0 if rate >= 1.0 else max(MIN_SPEED, 0.3 * rate)
        speeds = torch.clamp(speeds, min=min_speed)
        capacity = g.capacity(L, min_speed)
        if capacity_factor is not None and rate > 1.0:
            capacity = min(capacity, int(np.ceil(capacity_factor * L / rate / g.hop) + 2) * g.hop)
        req_max = 1.6 * rate - 0.6 + 1.0 if rate > 1.0 else 2.0
        ceiling = float(np.ceil(max(req_max * nl + rate * (1.0 - nl), req_max, rate, 2.0) * 2.0) / 2.0)
        lengths = torch.full((n,), L, dtype=torch.int64)
        out, valid = self.wsola(xs, lengths, speeds, gain, capacity, ceiling)
        return Result(tension, speeds, out, valid)

    def file(self, x: np.ndarray, rate: float, nl: float, fb: float) -> Result:
        """nonlinear_speedup's contract for one int16 file x [L]: the input
        scaled by 2^-15; nl = 0 is WSOLA at the constant rate; otherwise
        the capacity is planned from the slowest frame (times 0.999)."""
        xf = torch.from_numpy(x.astype(np.float32) / np.float32(32768.0))[None]
        L = xf.shape[1]
        one = torch.ones(1)
        if nl == 0.0:
            tension = torch.zeros(1, 0)
            speeds = torch.tensor([[rate]], dtype=torch.float32)
            min_speed = max(MIN_SPEED, rate * 0.999)
        else:
            tension = self.analysis(xf, None)
            speeds = self.speed_law(tension, rate, fb, nl)
            min_speed = max(MIN_SPEED, float(speeds.min()) * 0.999)
        capacity = self.g.capacity(L, min_speed)
        out, valid = self.wsola(xf, torch.tensor([L]), speeds, one, capacity)
        return Result(tension, speeds, out, valid)


def to_int16(y: torch.Tensor) -> np.ndarray:
    """Float output rounded to int16 as speedy_wave writes it."""
    return np.clip(np.round(y.cpu().numpy() * 32768.0), -32768, 32767).astype(np.int16)
