"""The PyTorch port's experimental row gathers, kernels.gather_rows_pipelined
(kernel 6) and kernels.gather_rows_coalesced (kernel 7), against the JAX
package's gather_rows_pipelined and gather_rows_coalesced in interpret
mode on the CPU, where each wrapper takes its plain version, on seeded
inputs; and the argument and device rules of the new gather wrappers.

The JAX kernels index a flattened x, so a start past L - width reads into
the next utterance there; the comparisons use starts in [0, L - width],
where both define the same rows. Tolerance: none, the rows are equal.
Kernel 7's route is the port's own exact test (every row of a block in
the span from its first start), which may part from the TPU kernel's
1024-aligned test at the edges; the rows never do."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import speedy_tpu.ops.pallas_coalesced as pc
import speedy_tpu.ops.pallas_kernels as pk

from speedy_tpu_torch.ops import kernels


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode (the fixture of
    tests/test_pallas_kernels.py, copied)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)
    monkeypatch.setattr(pc.pl, "pallas_call", interp)
    # The jitted wrappers close over pl.pallas_call at trace time; clear
    # their caches so the patched version is traced.
    for fn in (pk.gather_rows_pipelined, pc.gather_rows_coalesced):
        fn.clear_cache()
    yield
    for fn in (pk.gather_rows_pipelined, pc.gather_rows_coalesced):
        fn.clear_cache()


@pytest.mark.parametrize("width", [321, 441])
def test_gather_rows_pipelined_matches_jax(interpret_pallas, width):
    """Sorted in-range starts (the case of tests/test_pallas.py:56-68 at
    B=2, K=16, L=8000)."""
    rng = np.random.default_rng(3)
    B, K, L = 2, 16, 8000
    x = rng.normal(size=(B, L)).astype(np.float32)
    starts = np.sort(rng.integers(0, L - width + 1, size=(B, K)), axis=1).astype(np.int32)
    starts[0, 0], starts[1, -1] = 0, L - width
    want = np.asarray(pk.gather_rows_pipelined(jnp.asarray(x), jnp.asarray(starts), width))
    kernels.reset_launches()
    got = kernels.gather_rows_pipelined(torch.as_tensor(x), torch.as_tensor(starts), width)
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["sorted", "random"])
def test_gather_rows_coalesced_matches_jax(interpret_pallas, kind):
    """Sorted starts a few hundred samples apart take the span route,
    random ones the per-row route (the cases of tests/test_pallas.py:39-53
    at B=2, K=16, L=20000)."""
    rng = np.random.default_rng(2)
    B, K, W, L = 2, 16, 321, 20000
    x = rng.normal(size=(B, L)).astype(np.float32)
    if kind == "sorted":
        starts = np.sort(np.cumsum(rng.integers(150, 400, size=(B, K)), axis=1), axis=1)
    else:
        starts = rng.integers(0, L - W - 2048, size=(B, K))
    starts = starts.astype(np.int32)
    want = np.asarray(pc.gather_rows_coalesced(jnp.asarray(x), jnp.asarray(starts), W))
    kernels.reset_launches()
    got = kernels.gather_rows_coalesced(torch.as_tensor(x), torch.as_tensor(starts), W)
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), want)
    route = kernels.coalesced_span_blocks(torch.as_tensor(starts), W, 64, L)
    assert bool(route.all()) if kind == "sorted" else not bool(route.all())


def test_coalesced_route_is_exact():
    """A block takes the span route iff every row's clamped start s has
    s0 <= s and s + width <= s0 + span_rows*128 (s0 the block's first)."""
    width, span = 321, 64 * 128
    edge = span - width
    starts = torch.tensor([
        [0, 10, 20, 30, 40, 50, 60, edge],      # the last row ends at the span's end
        [0, 10, 20, 30, 40, 50, 60, edge + 1],  # one sample past it
        [100, 99, 200, 300, 400, 500, 600, 700],  # a row before the first
        [5000, 0, 0, 0, 0, 0, 0, 0],
    ], dtype=torch.int32).reshape(1, 32)
    got = kernels.coalesced_span_blocks(starts, width, 64, 20000)
    assert got.tolist() == [[True, False, False, False]]


def test_coalesced_needs_whole_blocks():
    x = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.gather_rows_coalesced(x, torch.zeros(1, 12, dtype=torch.int32), 321)


def test_block_gather_arguments_are_checked():
    x = torch.zeros(1, 4000)
    starts = torch.zeros(1, 8, dtype=torch.int32)
    for fn in (kernels.gather_rows_block, kernels.gather_rows_block_v2):
        with pytest.raises(ValueError, match="w_span >= width"):
            fn(x, starts, 321, 128, 320)
        with pytest.raises(ValueError, match="rows_per_block >= 1"):
            fn(x, starts, 321, 0, 1024)


@pytest.mark.parametrize("name", [
    "gather_rows_block", "gather_rows_block_v2", "gather_rows_pipelined",
    "gather_rows_coalesced",
])
def test_new_gathers_have_no_route_off_cpu_and_cuda(name):
    """A device that is neither the CPU nor CUDA raises (no kernel, no plain
    version), as do inputs on several devices; nothing is launched."""
    extra = (128, 1024) if name.startswith("gather_rows_block") else ()
    fn = getattr(kernels, name)
    x = torch.zeros(1, 1000, device="meta")
    starts = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        fn(x, starts, 321, *extra)
    with pytest.raises(ValueError, match="several devices"):
        fn(torch.zeros(1, 1000), starts, 321, *extra)
    assert not any(kernels.LAUNCHES.values())
