"""Analysis DFT: the Hamming window, the real-DFT basis and the magnitude
spectrogram (port of speedy_tpu/ops/dft.py).

The tables are built in float64 with numpy and cast once, with the same
recipe as the JAX package, so the two packages' tables are bitwise equal
(tests/test_torch_config.py). The reference zero-pads a Hamming-windowed
frame of W samples to 2W and takes a complex FFT (speedy.c:438-474); for
real input only bins 0..W are distinct, so the transform is a product
with a [W, W+1] cosine and a [W, W+1] minus-sine basis. The JAX package
leaves that product to XLA, outside any Pallas kernel; here it is
torch.matmul, in full float32 (no_tf32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SpeedyConfig


def no_tf32() -> None:
    """Full float32 for every matmul and convolution on the card (the
    analysis DFT and the plain pitch search need it; TF32 keeps about
    three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=16)
def hamming_window(window_size: int, dtype: str = "float32") -> np.ndarray:
    """Hamming window as designed in speedyCreateStream (speedy.c:256-258)."""
    i = np.arange(window_size, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (window_size - 1.0))
    return w.astype(dtype)


@functools.lru_cache(maxsize=16)
def dft_matrices(window_size: int, dtype: str = "float32"):
    """Real/imag DFT basis for a real input zero-padded from W to N=2W.

    Returns (cos_mat, sin_mat), each [W, W+1]: bin k of frame f is
    sum_n f[n]·exp(-2πi·k·n/N), bins 0..W covering DC..Nyquist.
    """
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(window_size + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / (2.0 * window_size)
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


def magnitude_spectrogram(frames: torch.Tensor, cfg: SpeedyConfig) -> torch.Tensor:
    """|DFT| of Hamming-windowed, zero-padded frames: [..., T, W] ->
    [..., T, W+1], bins 0..fft_size/2 of speedySpectrogram
    (speedy.c:438-454)."""
    dt, dev = frames.dtype, frames.device
    name = str(dt).removeprefix("torch.")
    win = torch.as_tensor(hamming_window(cfg.window_size, name), device=dev)
    cos_m, sin_m = (
        torch.as_tensor(m, device=dev) for m in dft_matrices(cfg.window_size, name)
    )
    fw = frames * win
    re = torch.matmul(fw, cos_m)
    im = torch.matmul(fw, sin_m)
    return torch.sqrt(re * re + im * im)


def full_magnitude(half: torch.Tensor, cfg: SpeedyConfig) -> torch.Tensor:
    """Bins [..., W+1] -> the reference's full fft_size array
    (speedy.c:450-452 stores all 2W bins; the upper half mirrors 1..W-1)."""
    W = cfg.window_size
    return torch.cat([half[..., : W + 1], half[..., 1:W].flip(-1)], dim=-1)
