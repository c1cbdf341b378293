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
bit; for the dot forms, how far the kernel's product with a seeded
normal E (not the identity) lies from its plain version's, against the
float32 bound F * 2^-24 * sum |x||E| of each output; and on the card the
kernel's and the library call x[:, :8].t().contiguous()'s median ms,
timed as pairs, each one's host cost of a launch (us), the kernel's and
the library's device ms, and the plain version's ms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import (device_ms, launch_us, launched, paired_ms, probe_device, require, run_main,
               time_ms)

F, C = 512, 128  # experiments/mosaic_transpose_probe.py:20, 25
FORMS = kernels.TRANSPOSE_FORMS
DOT_FORMS = ("dot_rhsT", "dot_lhsT")


def inputs(device) -> tuple:
    """x [512, 128] (mosaic_transpose_probe.py:60) and the [512, 512]
    identity."""
    x = np.random.default_rng(0).standard_normal((F, C)).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.eye(F, dtype=torch.float32, device=device)


def seeded_eye(device) -> torch.Tensor:
    """A [512, 512] E of seed-1 standard normals: the dot forms'
    products beyond the identity."""
    E = np.random.default_rng(1).standard_normal((F, F)).astype(np.float32)
    return torch.as_tensor(E, device=device)


def product_bound(x: torch.Tensor, E: torch.Tensor, form: str) -> torch.Tensor:
    """[8, F] float64: F * 2^-24 * sum |x||E| over each output's products,
    the float32 rounding bound of a sum of at most F products."""
    mags = kernels.transpose_cols_reference(x.double().abs(), E.double().abs(), form)
    return F * 2.0 ** -24 * mags


def library(x: torch.Tensor) -> torch.Tensor:
    return x[:, : kernels.TRANSPOSE_COLS].t().contiguous()


def check(device="cuda") -> list:
    """Per form, whether kernel 15 equals x[:, :8]^T bit for bit; it must,
    and equal its plain version bit for bit. The dot forms also hold their
    product with seeded_eye to the plain version's within product_bound.
    One row a form."""
    device = probe_device(device)
    x, eye = inputs(device)
    E = seeded_eye(device)
    want = library(x)
    rows = []
    for form in FORMS:
        out, n = launched("transpose_cols", lambda: kernels.transpose_cols(x, eye, form))
        exact = bool(torch.equal(out, want))
        plain = kernels.transpose_cols_reference(x, eye, form)
        require(exact, form, "differs from the library call")
        require(torch.equal(out, plain), form, "differs from the plain version")
        seeded = {}
        if form in DOT_FORMS:
            err = (kernels.transpose_cols(x, E, form).double()
                   - kernels.transpose_cols_reference(x, E, form).double()).abs()
            over = float((err / product_bound(x, E, form)).max())
            require(over <= 1.0, form, "with a seeded E is off its plain version by", over,
                    "of the float32 bound")
            seeded = dict(seeded_max_abs_err=float(err.max()), seeded_err_over_bound=over)
        call = lambda: kernels.transpose_cols(x, eye, form)
        ms, library_ms = paired_ms(call, lambda: library(x), device)
        rows.append(dict(
            probe="mosaic_transpose", form=form, F=F, C=C, launches=n, exact=exact,
            max_abs_err=float((out - plain).abs().max()), **seeded,
            ms=ms, library_ms=library_ms, launch_us=launch_us(call, device),
            library_launch_us=launch_us(lambda: library(x), device),
            device_ms=device_ms(call, device),
            library_device_ms=device_ms(lambda: library(x), device),
            plain_ms=time_ms(lambda: kernels.transpose_cols_reference(x, eye, form), device)))
    return rows


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
