"""Kernel 3's plan (ops/synth_model.py) on the CPU: the float32 model that
walks csrc/synth.cu's plan (runs of slots a block, staged chunk spans
aligned down and zero-filled, runs of zeros past valid, the straddling
run's mask) equals the plain version gather_synth_reference bit for bit
at the hops of 8 to 48 kHz, and the JAX package's XLA synthesis within
test_torch_synth.py's tolerance. The kernel cannot run here; chip_smoke.py
holds it equal to both on the card."""

import numpy as np
import pytest
import torch

from speedy_tpu_torch.ops import _build, kernels, synth_model
from speedy_tpu_torch.ops.wsola_fast import _cola_hann
from test_torch_synth import _case as jax_case
from test_torch_synth import _xla_synthesis

HOPS = (80, 110, 160, 220, 441, 480)


def _positions(rng, B, K, hop, L, rate=3.5):
    """Near-monotone chunk positions as the grid engine produces them,
    clipped to [0, L-1]: the first chunk at 0, and once the steps run past
    the row, every later one at L-1."""
    steps = rng.uniform(0.6 * rate * hop, 1.4 * rate * hop, (B, K))
    a = np.minimum(np.cumsum(steps, axis=1) - steps[:, :1], L - 1.0)
    a_i = np.floor(a).astype(np.int32)
    return a_i, (a - a_i).astype(np.float32)


def _case(name, hop):
    """(x, a_i, a_f, win, gain, valid, hop, capacity) of one plan case."""
    rng = np.random.default_rng(hop)
    if name == "long_row":
        # B=1 over 1,703 slots: runs of 3 to 6 (as the hop sets a block's
        # warps), the last one short; the buffer ends inside its last slot.
        B, K = 1, 1703
        capacity = K * hop - hop // 2
        L = int(3.5 * hop * K)
        valid = [capacity]
    elif name == "valid_zero_cut_full":
        # Runs of 4 to 8: nothing valid, a cut 13 samples into slot 43
        # (inside a run), and the whole buffer.
        B, K = 3, 751
        capacity = (K - 1) * hop
        L = int(3.5 * hop * K)
        valid = [0, (5 * 8 + 3) * hop + 13, capacity]
    elif name == "ends":
        # Rows of L = 40*hop + 3 under 200 chunks: the first chunk at 0,
        # most of them clipped to L-1 (reads past the end), and a row whose
        # every start is -1 (reads before the start), as an empty
        # utterance's clipped positions are.
        B, K = 4, 200
        capacity = (K - 1) * hop
        L = 40 * hop + 3
        valid = [capacity, capacity - hop // 3, capacity, capacity]
    elif name == "ragged_run":
        # Runs of 3 to 7 over 332 slots (the last one short), x a view one
        # float past a 16-byte boundary, so every row's spans align
        # differently.
        B, K = 6, 333
        capacity = (K - 1) * hop
        L = int(3.5 * hop * K) + 1
        valid = rng.integers(capacity // 2, capacity + 1, B)
    else:
        raise ValueError(name)
    a_i, a_f = _positions(rng, B, K, hop, L)
    if name == "ends":
        a_i[3], a_f[3] = -1, 0.0
    x = rng.standard_normal(B * L + 1).astype(np.float32)
    xt = torch.as_tensor(x)[1:].view(B, L) if name == "ragged_run" else (
        torch.as_tensor(x[: B * L].reshape(B, L)))
    t = torch.as_tensor
    return (xt, t(a_i), t(a_f), t(_cola_hann(2 * hop)),
            t(rng.uniform(0.5, 1.3, B).astype(np.float32)),
            t(np.asarray(valid, np.int32)), hop, capacity)


@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("name", ("long_row", "valid_zero_cut_full", "ends", "ragged_run"))
def test_model_equals_plain_version_bitwise(name, hop):
    args = _case(name, hop)
    x, a_i, valid, capacity = args[0], args[1], args[5], args[7]
    B = x.shape[0]
    plan = synth_model.synth_plan(B, hop, capacity)
    assert plan.run > 1 or name == "ends"
    got = synth_model.gather_synth_model(*args)
    want = kernels.gather_synth_reference(*args)
    assert got.shape == (B, capacity)
    assert not torch.isnan(got).any()  # no live read outside a staged span
    assert torch.equal(got, want)
    if name == "valid_zero_cut_full":
        assert not got[0].any() and not got[1, int(valid[1]):].any()
        assert got[1, int(valid[1]) - 1] != 0 and got[2].any()
    if name == "long_row":
        assert plan.slots % plan.run != 0 and plan.runs * plan.run > plan.slots
    if name == "ragged_run":
        assert x.data_ptr() % 16 != 0
        assert plan.slots % plan.run != 0
    if name == "ends":
        assert int(a_i[0, 0]) == 0 and int(a_i[0, -1]) == x.shape[1] - 1


@pytest.mark.parametrize("hop,K", [(160, 300), (220, 256), (441, 120)])
def test_model_matches_jax_xla_synthesis(hop, K):
    """The model against speedy_tpu's XLA synthesis on the same seeded
    numpy inputs, within test_torch_synth.py's 2e-5 (the JAX route scales
    the source by gain before the window, the port the output after)."""
    x, starts, af, gain, valid = jax_case(hop, K)
    B = x.shape[0]
    capacity = K * hop - hop // 2
    got = synth_model.gather_synth_model(
        torch.as_tensor(x), torch.as_tensor(starts), torch.as_tensor(af),
        torch.as_tensor(_cola_hann(2 * hop)), torch.as_tensor(gain),
        torch.as_tensor(valid), hop, capacity,
    ).numpy()
    xla = _xla_synthesis(x, starts, af, gain, hop)
    for b in range(B):
        v = min(int(valid[b]), capacity)
        np.testing.assert_allclose(got[b, :v], xla[b, :v], rtol=0, atol=2e-5)
        assert not got[b, v:].any()


@pytest.mark.parametrize("B,hop,capacity,run", [
    (128, 160, 382 * 160, 16),  # the batch step at 16 kHz, 10 s, 3.5x
    (8, 220, 399 * 220, 12),
    (4, 441, 399 * 441, 6),
    (32, 441, 399 * 441, 16),
    (1, 160, 5600 * 160, 14),  # one long utterance at 1.0x
    (1, 160, 1714 * 160, 4),  # 60 s at 16 kHz, 3.5x, a 6.6x ceiling
    (8, 110, 399 * 110, 8),  # four warps a block
    (8, 80, 399 * 80, 6),  # three warps a block
    (8, 480, 399 * 480, 12),
    (2, 80, 40 * 80, 1),
])
def test_plan_fills_every_sm(B, hop, capacity, run):
    """S is the longest run (at most 16) that still gives every SM two
    blocks and at least 12 warps in whole blocks."""
    plan = synth_model.synth_plan(B, hop, capacity)
    assert plan.run == run
    assert plan.runs == -(-plan.slots // run)
    per_sm = max(2, -(-synth_model.WARPS_PER_SM * 32 // plan.threads))
    assert per_sm * plan.threads >= synth_model.WARPS_PER_SM * 32
    if run < synth_model.RUN_MAX and run > 1:
        assert B * plan.runs >= per_sm * synth_model.SMS
        assert B * -(-plan.slots // (run + 1)) < per_sm * synth_model.SMS
    assert plan.threads % 32 == 0 and plan.threads >= min(hop, synth_model.THREADS_MAX)
    assert plan.shared_bytes + synth_model.STATIC_SHARED <= synth_model.SHARED_OPTIN


def test_plan_cuts_the_run_to_fit_shared_memory():
    plan = synth_model.synth_plan(64, 2048, 2000 * 2048)
    assert 1 < plan.run < synth_model.RUN_MAX
    assert plan.shared_bytes + synth_model.STATIC_SHARED <= synth_model.SHARED_OPTIN
    more = synth_model._shared_bytes(2048, plan.run + 1)
    assert more + synth_model.STATIC_SHARED > synth_model.SHARED_OPTIN


@pytest.mark.parametrize("hop", (110, 160, 441))
def test_spans_are_aligned_and_read_x_about_once(hop):
    """Every staged span starts on a 16-byte boundary of x's memory, fits
    its stride, and the spans stage each covered sample of x at least once
    and at most once plus the alignment slack: at 3.5x chunks do not
    overlap, and a chunk split between two runs stages its middle sample
    twice."""
    args = _case("ragged_run", hop)
    x, a_i, valid, capacity = args[0], args[1], args[5], args[7]
    B, L = x.shape
    plan = synth_model.synth_plan(B, hop, capacity)
    sp = synth_model.staged_spans(x, a_i, valid, hop, capacity, plan)
    staged = sp.granules > 0
    rows = torch.arange(B)[:, None, None].expand_as(sp.base)
    assert bool(((x.data_ptr() // 4 + rows * L + sp.base)[staged] % 4 == 0).all())
    assert int(sp.granules.max()) * 4 <= plan.stride
    assert torch.equal(staged, sp.first | sp.second)
    # Samples of x the live slots need, each once.
    K = a_i.shape[1]
    need = np.zeros((B, L + 2 * hop + 8), bool)
    for b in range(B):
        for k in range(K):
            if k * hop < min(int(valid[b]), capacity):
                a = int(a_i[b, k])
                need[b, a : a + hop + 1] = True
                if k >= 1:
                    p = int(a_i[b, k - 1])
                    need[b, p + hop : p + 2 * hop + 1] = True
    need = need[:, :L]
    got = np.zeros_like(need)
    count = 0
    for b, r, i in torch.nonzero(staged).tolist():
        lo = int(sp.base[b, r, i])
        q = np.arange(lo, lo + 4 * int(sp.granules[b, r, i]))
        q = q[(q >= 0) & (q < L)]
        got[b, q] = True
        count += len(q)
    assert not (need & ~got).any()
    assert need.sum() <= count <= need.sum() + 7 * int(staged.sum())


def test_wrapper_launches_with_the_plans_run(monkeypatch):
    """On a card the wrapper passes the plan's S after capacity, and the
    arguments fill the entry point's signature."""
    calls = []
    monkeypatch.setattr(kernels, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *a: calls.append((name, a)))
    args = _case("ragged_run", 160)
    x = args[0].contiguous()
    kernels.gather_synth(x, *args[1:])
    (name, launched), = calls
    B, capacity = x.shape[0], args[7]
    assert name == "gather_synth"
    assert launched[-6:] == (B, x.shape[1], args[1].shape[1], 160, capacity,
                             synth_model.synth_plan(B, 160, capacity).run)
    assert len(launched) + 1 == len(_build._SIGNATURES["speedy_gather_synth"])
