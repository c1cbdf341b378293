"""Does a bf16 split matmul keep float32's accuracy on the H100's tensor
cores, and what does it cost against float32 FMA?

Port of experiments/bf16_split_probe.py through kernel 9
(kernels.bf16_split_matmul, csrc/bf16_split.cu), in the probe's four
modes: conv3 (h = bf16(x), l = bf16(x - h), three passes), bitcast (h the
top 16 bits), default (one bf16 pass, as on the TPU) and highest
(float32). Two cases:
  - the probe's own: seed 7, [256, 256] @ [256, 256] standard normals;
  - kernel 1's DFT product at the batch step: the Hamming-windowed frames
    of B = 128 utterances of 10 s at 16 kHz (B x 999 frames of 240 samples of
    seeded noise) @ the [240, 241] cosine basis (ops/dft.py's
    dft_matrices), the product speedy_tpu/ops/dft.py computes at HIGH,
    i.e. conv3.

    python -m speedy_tpu_torch.experiments.bf16_split_probe [--device cuda]

Prints one JSON line a case and mode: max |err| / max |ref| against a
float64 product for the kernel and for the plain version, and on the card
the median ms of the kernel, the plain version and the library call
(torch.matmul of the bf16 inputs for default, float32 torch.matmul
without TF32 for highest; the splits have none).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SpeedyConfig
from ..ops import dft, kernels
from . import device_ms, launched, probe_device, require, run_main, time_ms

MODES = kernels.BF16_MODES
PROBE_SHAPE = (256, 256, 256)  # M, K, N (experiments/bf16_split_probe.py:29)
PROBE_SEED = 7
DFT_BATCH, DFT_SECONDS, DFT_RATE = 128, 10, 16000


def probe_inputs(device) -> tuple:
    """The probe's a [256, 256] and b [256, 256] (bf16_split_probe.py:80-82)."""
    M, K, N = PROBE_SHAPE
    rng = np.random.default_rng(PROBE_SEED)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


def dft_inputs(device, seed: int = 0) -> tuple:
    """Kernel 1's DFT operands at DFT_BATCH utterances of 10 s at 16 kHz:
    frames [DFT_BATCH * 999, 240], each f*160 + [0, 240) of seeded noise
    times the Hamming window, and the [240, 241] cosine basis."""
    cfg = SpeedyConfig(DFT_RATE)
    W, step = cfg.window_size, cfg.frame_step_int
    L = DFT_SECONDS * DFT_RATE
    T = cfg.num_frames(L, integer_step=True)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((0.1 * rng.standard_normal((DFT_BATCH, L))).astype(np.float32),
                        device=device)
    win = torch.as_tensor(dft.hamming_window(W), device=device)
    frames = (x.unfold(1, W, step)[:, :T] * win).reshape(DFT_BATCH * T, W).contiguous()
    return frames, torch.as_tensor(dft.dft_matrices(W)[0], device=device)


def cases(device):
    yield "probe [256,256]@[256,256]", probe_inputs(device)
    yield f"kernel 1 DFT B={DFT_BATCH}", dft_inputs(device)


def rel_err(out: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    return float((out.double() - ref).abs().max()) / scale


def _library(a: torch.Tensor, b: torch.Tensor, mode: str):
    """One PyTorch call computing the mode's product, or None."""
    if mode == "default":
        ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
        return lambda: torch.matmul(ah, bh)
    if mode == "highest":
        return lambda: torch.matmul(a, b)
    return None


def check(device="cuda") -> list:
    """Each mode's max |err| / max |ref| against float64 through kernel 9
    at both cases, and the kernel against its plain version: within 1e-5
    of max |ref| (the tensor cores sum in another order than float32 `@`,
    so not bitwise); its own error at most twice the plain version's plus
    1e-6; and in a bf16 mode, whose error the split's rounding sets
    whatever the order of the sums, within a quarter of the plain
    version's plus 1e-7 (so a kernel computing another mode fails). One
    row a case and mode."""
    device = probe_device(device)
    rows = []
    for label, (a, b) in cases(device):
        ref = a.double() @ b.double()
        scale = float(ref.abs().max())
        (M, K), N = a.shape, b.shape[1]
        for mode in MODES:
            out, n = launched("bf16_split_matmul", lambda: kernels.bf16_split_matmul(a, b, mode))
            plain = kernels.bf16_split_matmul_reference(a, b, mode)
            d = float((out - plain).abs().max())
            err, plain_err = rel_err(out, ref, scale), rel_err(plain, ref, scale)
            require(bool(torch.isfinite(out).all()), label, mode, "non-finite")
            require(d <= 1e-5 * scale, label, mode, "kernel against plain", d, scale)
            require(err <= 2 * plain_err + 1e-6, label, mode, "kernel error", err, plain_err)
            require(mode == "highest" or abs(err - plain_err) <= 0.25 * plain_err + 1e-7,
                    label, mode, "kernel error away from the plain split's", err, plain_err)
            del out, plain
            library = _library(a, b, mode)
            call = lambda: kernels.bf16_split_matmul(a, b, mode)
            rows.append(dict(
                probe="bf16_split", case=label, mode=mode, M=M, K=K, N=N, launches=n,
                rel_err=err, plain_rel_err=plain_err, max_abs_err=d, max_abs_ref=scale,
                ms=time_ms(call, device), device_ms=device_ms(call, device),
                plain_ms=time_ms(lambda: kernels.bf16_split_matmul_reference(a, b, mode),
                                 device),
                library_ms=None if library is None else time_ms(library, device)))
        del ref
    return rows


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
