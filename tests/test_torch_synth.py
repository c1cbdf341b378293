"""The PyTorch port's fused synthesis (plain version of kernel 3, taken by
CPU tensors) against the JAX package's gather_synth_block_pallas in
interpret mode and against its XLA synthesis, at the hops of 16, 22.05 and
44.1 kHz, with per-utterance gain and valid-length skips."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speedy_tpu.ops.pallas_kernels as pk
from speedy_tpu.ops.wsola_fast import _cola_hann as jax_cola_hann

from speedy_tpu_torch import trace
from speedy_tpu_torch.ops import kernels
from speedy_tpu_torch.ops.wsola_fast import _cola_hann

R = 64  # rows per span block of the Pallas kernel


def _case(hop, K, seed=7, B=3, L=60000, max_step_factor=4.5):
    """Near-monotone chunk starts with fractional delays, as the grid
    engine produces them (tests/test_pallas_kernels.py:115)."""
    rng = np.random.default_rng(seed)
    width = 2 * hop + 1
    x = rng.standard_normal((B, L)).astype(np.float32)
    steps = rng.uniform(hop * 0.5, hop * max_step_factor, (B, K))
    starts = np.minimum(np.cumsum(steps, axis=1).astype(np.int32), L - width - 1)
    af = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    gain = np.array([0.9, 0.55, 1.3], np.float32)[:B]
    # Valid samples: a whole buffer, a ragged cut inside a slot, nothing.
    valid = np.array([K * hop, 57 * hop + 37, 0], np.int32)[:B]
    return x, starts, af, gain, valid


def _xla_synthesis(x, starts, af, gain, hop):
    """The XLA synthesis of speedy_tpu/ops/wsola_fast.py:593-622 (gain
    folded into the source), slots flattened to [B, K*hop]."""
    B, K = starts.shape
    wide = pk.gather_rows_reference(
        jnp.asarray(x * gain[:, None]), jnp.asarray(starts), 2 * hop + 1
    )
    afj = jnp.asarray(af)[:, :, None]
    raw = wide[:, :, :-1] * (1.0 - afj) + wide[:, :, 1:] * afj
    rows = raw * jnp.asarray(jax_cola_hann(2 * hop))[None, None, :]
    slots = rows[:, :, :hop] + jnp.concatenate(
        [jnp.zeros((B, 1, hop), jnp.float32), rows[:, :-1, hop:]], axis=1
    )
    slots = jnp.concatenate([raw[:, :1, :hop], slots[:, 1:]], axis=1)
    return np.asarray(slots).reshape(B, K * hop)


@pytest.mark.parametrize("hop,K", [(160, 300), (220, 256), (441, 120)])
def test_gather_synth_matches_pallas_and_xla(hop, K):
    x, starts, af, gain, valid = _case(hop, K)
    B = x.shape[0]
    width = 2 * hop + 1
    need = (R - 1) * int(np.ceil(hop * 5.0)) + width + 32
    w_span = -(-need // 1024) * 1024
    n_valid_rows = np.minimum(valid // hop + 2, K).astype(np.int32)
    pallas = np.asarray(
        pk.gather_synth_block_pallas(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(af), hop, width,
            R, w_span, jnp.asarray(n_valid_rows), interpret=True,
            gain=jnp.asarray(gain),
        )
    ).reshape(B, K * hop)
    xla = _xla_synthesis(x, starts, af, gain, hop)

    capacity = K * hop - hop // 2  # the buffer ends inside the last slot
    got = kernels.gather_synth(
        torch.as_tensor(x), torch.as_tensor(starts), torch.as_tensor(af),
        torch.as_tensor(_cola_hann(2 * hop)), torch.as_tensor(gain),
        torch.as_tensor(valid), hop, capacity,
    ).numpy()
    assert got.shape == (B, capacity)
    for b in range(B):
        v = min(int(valid[b]), capacity)
        for ref in (pallas, xla):
            np.testing.assert_allclose(got[b, :v], ref[b, :v], rtol=0, atol=2e-5)
        assert not got[b, v:].any()
    assert not any(trace.LAUNCHES.values())


def test_gather_synth_reads_zero_outside_signal():
    """Positions at the signal's ends read zeros past either edge, as the
    XLA path's zero padding does; a -1 start (an empty utterance's
    clipped position) reads nothing."""
    hop, K, L = 160, 12, 2000
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, L)).astype(np.float32)
    starts = np.tile(np.linspace(0, L - 1, K).astype(np.int32), (2, 1))
    starts[1] = -1
    af = np.full((2, K), 0.25, np.float32)
    gain = np.ones(2, np.float32)
    valid = np.array([K * hop, K * hop], np.int32)
    got = kernels.gather_synth(
        torch.as_tensor(x), torch.as_tensor(starts), torch.as_tensor(af),
        torch.as_tensor(_cola_hann(2 * hop)), torch.as_tensor(gain),
        torch.as_tensor(valid), hop, K * hop,
    ).numpy()
    xp = np.concatenate([x, np.zeros((2, 3 * hop), np.float32)], axis=1)
    ref = _xla_synthesis(xp[:1], starts[:1], af[:1], gain[:1], hop)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    # Row 1 reads x[-1] (zero) and x[0] weighted by af in its first sample.
    np.testing.assert_allclose(got[1, 0], 0.25 * x[1, 0], rtol=1e-6)
