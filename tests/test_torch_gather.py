"""The PyTorch port's per-row gather (kernels.gather_rows, whose CPU route is
its plain version gather_rows_reference) against the JAX package's
gather_rows_reference (vmapped dynamic slices) and gather_rows_pallas in
interpret mode, at the row widths 2*hop + 1 of 16, 22.05 and 44.1 kHz.

Tolerance: none. Rows below n_valid equal the JAX package's exactly, and
rows at or past n_valid are zeros (the TPU kernel leaves them unspecified,
so they are compared with nothing)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import speedy_tpu.ops.pallas_kernels as pk

from speedy_tpu_torch import trace
from speedy_tpu_torch.ops import kernels

L = 12000


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run pk's pallas_call in interpret mode (the fixture of
    tests/test_pallas_kernels.py, copied)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)
    # The jitted wrapper closes over pl.pallas_call at trace time; clear
    # its cache so the patched version is traced.
    pk.gather_rows_pallas.clear_cache()
    yield
    pk.gather_rows_pallas.clear_cache()


def _case(width, kind, B=3, K=32, seed=0):
    """x [B, L] and starts [B, K] in [0, L - width], the first and last
    rows of utterance 0 at the edges 0 and L - width."""
    rng = np.random.default_rng(seed + width)
    x = rng.standard_normal((B, L)).astype(np.float32)
    if kind == "random":
        starts = rng.integers(0, L - width + 1, (B, K))
    else:  # monotone, as the grid engine's chunk positions
        steps = rng.integers(0, 2 * (L - width) // K, (B, K))
        starts = np.minimum(np.cumsum(steps, axis=1) - steps[:, :1], L - width)
    starts[0, 0], starts[0, -1] = 0, L - width
    return x, starts.astype(np.int32)


N_VALID = {"all": None, "partial": [32, 17, 5], "none": [0, 0, 0]}


def _check(rows, want, n_valid):
    K = rows.shape[1]
    nv = [K] * rows.shape[0] if n_valid is None else n_valid
    for b, n in enumerate(nv):
        np.testing.assert_array_equal(rows[b, :n], want[b, :n])
        assert np.all(rows[b, n:] == 0.0)


@pytest.mark.parametrize("n_valid", list(N_VALID))
@pytest.mark.parametrize("kind", ["random", "monotone"])
@pytest.mark.parametrize("width", [321, 441, 883])
def test_gather_rows_matches_jax(interpret_pallas, width, kind, n_valid):
    x, starts = _case(width, kind)
    nv = N_VALID[n_valid]
    nv_t = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    trace.reset()
    rows = kernels.gather_rows(torch.as_tensor(x), torch.as_tensor(starts), width, nv_t)
    assert trace.LAUNCHES["gather_rows"] == 0  # CPU tensors: the plain version
    rows = rows.numpy()
    assert rows.shape == (3, 32, width) and rows.dtype == np.float32
    xj, sj = jnp.asarray(x), jnp.asarray(starts)
    _check(rows, np.asarray(pk.gather_rows_reference(xj, sj, width)), nv)
    nv_j = None if nv is None else jnp.asarray(np.asarray(nv, np.int32))
    _check(rows, np.asarray(pk.gather_rows_pallas(xj, sj, width, 8, nv_j)), nv)


def test_out_of_range_starts_clamp():
    """Starts past L - width clamp to it, as jax.lax.dynamic_slice clamps
    them in the JAX package's gather_rows_reference. Negative starts clamp
    to 0 (dynamic_slice would first wrap them once by L; the engine's
    starts are never negative)."""
    width, n = 321, 2000
    x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    starts = np.array([[0, 1, 1679, 1680, 1999, 10**6],
                       [2, 3, 900, 1700, 1678, 2**31 - 1]], np.int32)
    got = kernels.gather_rows_reference(torch.as_tensor(x), torch.as_tensor(starts), width)
    want = np.asarray(pk.gather_rows_reference(jnp.asarray(x), jnp.asarray(starts), width))
    np.testing.assert_array_equal(got.numpy(), want)
    neg = np.array([[-1, -5, -(2**31)]], np.int32)
    got = kernels.gather_rows_reference(torch.as_tensor(x[:1]), torch.as_tensor(neg), width)
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(x[0, :width], (1, 3, width)))


def test_rows_wider_than_the_signal_raise():
    x = torch.zeros(1, 300)
    starts = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        kernels.gather_rows(x, starts, 321)


def test_other_devices_raise():
    x = torch.zeros(1, 1000, device="meta")
    starts = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        kernels.gather_rows(x, starts, 321)
    with pytest.raises(ValueError, match="several devices"):
        kernels.gather_rows(torch.zeros(1, 1000), starts, 321)
