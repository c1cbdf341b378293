"""The one generator of traffic: it reads a cell's traffic file
(portbench/traffic/<cell>.json) and makes that cell's inputs from the seed.

The four synthetic families are bench.py:295-316's (a male-like and a
female-like harmonic speech model, noise bursts, a pitch-chirped sweep),
copied from chip_smoke.py:147-175. They are made once at a fixed seed, so
every run carries the same work; the seed draws only the gains.
"""

from __future__ import annotations

import numpy as np
import torch

FAMILY_SEED = 0  # the noise family's seed in bench.py, the same in every run


def families(L: int, sr: int, seed: int = FAMILY_SEED) -> np.ndarray:
    """[4, L] float32: the four synthetic families of bench.py:295-316."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / sr

    def speechlike(f0_base, f0_mod, f0_rate, syll_hz, n_harm):
        f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
        phase = np.cumsum(2 * np.pi * f0 / sr)
        voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
        envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
        return (voiced * envelope * 0.2).astype(np.float32)

    fam0 = speechlike(110.0, 30.0, 0.7, 2.5, 5)
    fam1 = speechlike(210.0, 45.0, 1.3, 4.0, 7)
    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    fam2 = (rng.standard_normal(L) * 0.12 * bursts).astype(np.float32)
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / sr)
    fam3 = (
        (np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
        * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None)
        * 0.2
    ).astype(np.float32)
    return np.stack([fam0, fam1, fam2, fam3])


def samples(traffic: dict, config: dict, key: str) -> int:
    return int(round(traffic[key] * config["sample_rate"]))


def batch_rows(traffic: dict, config: dict, device) -> torch.Tensor:
    """[B, L] float32 on device: row b is family families[b % len]."""
    L = samples(traffic, config, "utterance_s")
    fam = torch.as_tensor(families(L, config["sample_rate"]), device=device)
    order = torch.as_tensor(traffic["families"], device=device)
    rows = torch.arange(traffic["batch"], device=device) % len(traffic["families"])
    return fam[order[rows]].contiguous()


def gain_bank(traffic: dict, seed: int, device) -> torch.Tensor:
    """[bank, B] float32 gains, uniform in traffic["gain"], drawn on device
    by a torch.Generator seeded with the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    lo, hi = traffic["gain"]
    u = torch.rand(traffic["gain_bank"], traffic["batch"], generator=gen, device=device)
    return (lo + (hi - lo) * u).contiguous()


def file_pool(traffic: dict, config: dict, seed: int) -> list:
    """traffic["pool"] int16 files of traffic["file_s"] seconds: file j is
    family families[j % len] at a gain drawn from the seed, rounded to
    int16 as a WAV file holds it. Returns [(family, array)]."""
    L = samples(traffic, config, "file_s")
    fam = families(L, config["sample_rate"])
    lo, hi = traffic["gain"]
    gains = np.random.default_rng(int(seed)).uniform(lo, hi, traffic["pool"])
    pool = []
    for j in range(traffic["pool"]):
        f = traffic["families"][j % len(traffic["families"])]
        y = np.round(fam[f].astype(np.float64) * gains[j] * 32768.0)
        pool.append((f, np.clip(y, -32768, 32767).astype(np.int16)))
    return pool
