"""Which column-to-row transpose form is exact on the H100, and which is
cheapest?

Port of experiments/mosaic_transpose_probe.py through kernel 15
(kernels.transpose_cols, csrc/transpose.cu): out [8, 512] = x[:, :8]^T for
x [512, 128] (seed 0 standard normals), by a tile transpose (swap), by
eye8 . cols^T (dot_rhsT) and by cols^T . eye512 (dot_lhsT, which reads the
whole identity). Kernel 1 on the TPU reduced per-frame values to columns
and wrote rows; the probe asked which form Mosaic lowers.

    python -m speedy_tpu_torch.experiments.mosaic_transpose_probe [--device cuda]

Prints one JSON line a form: whether the kernel equals x[:, :8]^T bit for
bit, and on the card the median ms of the kernel, its plain version and
the library call x[:, :8].t().contiguous().
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import device_ms, launched, probe_device, require, run_main, time_ms

F, C = 512, 128  # experiments/mosaic_transpose_probe.py:20, 25
FORMS = kernels.TRANSPOSE_FORMS


def inputs(device) -> tuple:
    """x [512, 128] (mosaic_transpose_probe.py:60) and the [512, 512]
    identity."""
    x = np.random.default_rng(0).standard_normal((F, C)).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.eye(F, dtype=torch.float32, device=device)


def library(x: torch.Tensor) -> torch.Tensor:
    return x[:, : kernels.TRANSPOSE_COLS].t().contiguous()


def check(device="cuda") -> list:
    """Per form, whether kernel 15 equals x[:, :8]^T bit for bit; it must,
    and equal its plain version bit for bit. One row a form."""
    device = probe_device(device)
    x, eye = inputs(device)
    want = library(x)
    rows = []
    for form in FORMS:
        out, n = launched("transpose_cols", lambda: kernels.transpose_cols(x, eye, form))
        exact = bool(torch.equal(out, want))
        plain = kernels.transpose_cols_reference(x, eye, form)
        require(exact, form, "differs from the library call")
        require(torch.equal(out, plain), form, "differs from the plain version")
        rows.append(dict(
            probe="mosaic_transpose", form=form, F=F, C=C, launches=n, exact=exact,
            max_abs_err=float((out - plain).abs().max()),
            ms=time_ms(lambda: kernels.transpose_cols(x, eye, form), device),
            device_ms=device_ms(lambda: kernels.transpose_cols(x, eye, form), device),
            plain_ms=time_ms(lambda: kernels.transpose_cols_reference(x, eye, form), device),
            library_ms=time_ms(lambda: library(x), device)))
    return rows


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
