"""Analysis DFT tables: the Hamming window and the real-DFT basis.

Built in float64 with numpy and cast once, with the same recipe as
speedy_tpu/ops/dft.py, so the two packages' tables are bitwise equal
(tests/test_torch_config.py). The reference zero-pads a Hamming-windowed
frame of W samples to 2W and takes a complex FFT (speedy.c:438-474); for
real input only bins 0..W are distinct, so the transform is a product
with a [W, W+1] cosine and a [W, W+1] minus-sine basis.
"""

from __future__ import annotations

import functools

import numpy as np


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
