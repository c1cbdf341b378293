"""The PyTorch port's probe kernels (9, 12, 13 and 15) against the JAX
experiments they port, on the CPU, where every wrapper takes its plain
version, on the probes' own seeded inputs.

Kernel 9 (kernels.bf16_split_matmul) is held to
experiments/bf16_split_probe.py's run(..., interpret=True). In conv3,
bitcast and highest the two agree within 1e-6 of max|ref|: both compute
bf16 x bf16 products exactly and sum them in float32, in other orders.
default is held to float64 only, not to JAX: on the CPU XLA computes a
DEFAULT-precision dot in float32, while the TPU, and the port, take one
bf16 pass (the probe's own docstring, :10). Every mode's error against
float64 is held in its band, so a split that silently loses its tail
(XLA folding bf16(x - f32(bf16(x))), pallas_kernels.py:34-39) fails.

Kernels 12, 13 and 15 are held to experiments/lane1_blockspec_probe.py,
multitile_roll_probe.py and mosaic_transpose_probe.py with pallas_call in
interpret mode: the rotate and the transposes bitwise, the narrow-operand
window within 1e-5 relative (JAX's scan sums in another order). Nothing in
experiments/ changes for this: each module is loaded from its file under
its own name.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from speedy_tpu_torch.experiments import (
    bf16_split_probe,
    lane1_blockspec_probe,
    mosaic_transpose_probe,
    multitile_roll_probe,
)
from speedy_tpu_torch.ops import kernels

EXPERIMENTS = pathlib.Path(__file__).resolve().parent.parent / "experiments"


def _load(name: str):
    """experiments/<name>.py as a fresh module (it runs its module-level
    code, so multitile_roll_probe's check runs under the caller's
    patches)."""
    spec = importlib.util.spec_from_file_location(f"jax_experiment_{name}",
                                                  EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Every pallas_call in interpret mode (the fixture of
    tests/test_pallas_kernels.py, copied)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp)


# ---------------------------------------------------------------------------
# Kernel 9: the bf16 split matmul
# ---------------------------------------------------------------------------

# Each mode's max |err| / max |ref| against float64 lies in its band (the
# probe's case measures 5.1e-6, 1.43e-5, 3.09e-3 and 6.7e-7).
BANDS = {"conv3": (0.0, 1e-5), "bitcast": (0.0, 3e-5), "default": (1e-3, 4e-3),
         "highest": (0.0, 2e-6)}


@pytest.fixture(scope="module")
def jax_bf16_probe():
    return _load("bf16_split_probe")


def _rel(out, ref) -> float:
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("mode", kernels.BF16_MODES)
def test_bf16_split_matches_the_jax_probe(jax_bf16_probe, mode):
    a, b = (t.numpy() for t in bf16_split_probe.probe_inputs("cpu"))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = kernels.bf16_split_matmul(torch.as_tensor(a), torch.as_tensor(b), mode).numpy()
    lo, hi = BANDS[mode]
    assert lo < _rel(got, ref) < hi
    if mode != "default":
        want = np.asarray(jax_bf16_probe.run(a, b, mode, interpret=True))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("mode", kernels.BF16_MODES)
def test_bf16_split_odd_shape_against_float64(mode):
    """A shape that is no multiple of 16, [37, 240] @ [240, 241] (kernel
    1's N), against float64 in the mode's band."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((37, 240)).astype(np.float32)
    b = rng.standard_normal((240, 241)).astype(np.float32)
    got = kernels.bf16_split_matmul(torch.as_tensor(a), torch.as_tensor(b), mode)
    assert got.shape == (37, 241) and got.dtype == torch.float32
    lo, hi = BANDS[mode]
    assert lo < _rel(got.numpy(), a.astype(np.float64) @ b.astype(np.float64)) < hi


def test_bf16_split_parts():
    """h + l reconstructs x to bf16's 16 bits of mantissa; bitcast's head
    is x with its low 16 bits cleared."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(1000).astype(np.float32))
    for mode in ("conv3", "bitcast"):
        h, lo = kernels.bf16_split(x, mode)
        assert h.dtype == lo.dtype == torch.bfloat16
        rel = ((h.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
        assert float(rel) < 2.0 ** -15
    h, _ = kernels.bf16_split(x, "bitcast")
    assert torch.equal(h.float().view(torch.int32), x.view(torch.int32) & -65536)


def test_bf16_split_probe_entry_point(capsys, monkeypatch):
    """The entry point on the CPU at a batch of one utterance: one JSON row
    a case and mode, errors in band, no time taken."""
    monkeypatch.setattr(bf16_split_probe, "DFT_BATCH", 1)
    assert bf16_split_probe.main(["--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["case"], r["mode"]) for r in rows] == [
        (case, mode) for case in ("probe [256,256]@[256,256]", "kernel 1 DFT B=1")
        for mode in kernels.BF16_MODES
    ]
    dft = [r for r in rows if r["case"].startswith("kernel 1")]
    assert {(r["M"], r["K"], r["N"]) for r in dft} == {(999, 240, 241)}
    for r in rows:
        lo, hi = BANDS[r["mode"]]
        assert lo < r["rel_err"] < hi and r["max_abs_err"] == 0.0 and r["ms"] is None
        assert r["launches"] == 0  # the plain version launches nothing


# ---------------------------------------------------------------------------
# Kernel 15: the column transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", kernels.TRANSPOSE_FORMS)
def test_transpose_matches_the_jax_probe(interpret_pallas, form):
    jax_probe = _load("mosaic_transpose_probe")
    x, eye = mosaic_transpose_probe.inputs("cpu")
    want = np.asarray(jax_probe.make(form)(x.numpy(), eye.numpy()))
    got = kernels.transpose_cols(x, eye, form).numpy()
    assert got.shape == (8, 512)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.numpy()[:, :8].T)


def test_transpose_probe_answers_exact():
    rows = mosaic_transpose_probe.check("cpu")
    assert [(r["form"], r["exact"], r["max_abs_err"], r["ms"]) for r in rows] == [
        (f, True, 0.0, None) for f in kernels.TRANSPOSE_FORMS]


@pytest.mark.parametrize("form", mosaic_transpose_probe.DOT_FORMS)
def test_transpose_dot_forms_are_products(form):
    """Beyond the identity the dot forms are products: on a seeded normal
    E the plain version (the wrapper on the CPU) lies within the float32
    bound F * 2^-24 * sum |x||E| of the float64 product, output by output,
    and is not x[:, :8]^T."""
    x, _ = mosaic_transpose_probe.inputs("cpu")
    E = mosaic_transpose_probe.seeded_eye("cpu")
    got = kernels.transpose_cols_reference(x, E, form)
    assert torch.equal(kernels.transpose_cols(x, E, form), got)
    want = kernels.transpose_cols_reference(x.double(), E.double(), form)
    err = (got.double() - want).abs()
    assert bool((err <= mosaic_transpose_probe.product_bound(x, E, form)).all())
    assert float(err.max()) > 0.0  # float32 rounding shows: the bound is not vacuous
    assert float((got - x[:, :8].t()).abs().max()) > 1.0


# ---------------------------------------------------------------------------
# Kernel 13: the lane roll
# ---------------------------------------------------------------------------


def test_lane_roll_matches_the_jax_probe(interpret_pallas, capsys):
    jax_probe = _load("multitile_roll_probe")  # runs its own check on import
    assert "OK exact" in capsys.readouterr().out
    x = multitile_roll_probe.inputs("cpu")
    want = np.asarray(jax_probe.run(x.numpy()))
    got = kernels.lane_roll(x, multitile_roll_probe.SHIFT).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [0, 1, 266, 511, 512, -3, 1000])
def test_lane_roll_is_np_roll(shift):
    x = np.random.default_rng(2).standard_normal((5, 512)).astype(np.float32)
    got = kernels.lane_roll(torch.as_tensor(x), shift).numpy()
    np.testing.assert_array_equal(got, np.roll(x, shift, axis=1))


# ---------------------------------------------------------------------------
# Kernel 12: the narrow operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", lane1_blockspec_probe.SHAPES, ids=["narrow", "lane-dense"])
def test_narrow_operands_match_the_jax_probe(interpret_pallas, shape):
    """The probe's window on random inputs and three amps, within 1e-5
    relative."""
    jax_probe = _load("lane1_blockspec_probe")
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal((96,) + shape).astype(np.float32) for _ in range(3))
    amps = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    want = float(jax_probe.make(shape)(a, b, c, amps))
    got = lane1_blockspec_probe.window(lane1_blockspec_probe.outputs(
        *(torch.as_tensor(t) for t in (a, b, c)), [float(v) for v in amps]))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_narrow_operand_rows():
    """Rows 0..7 of column 0: words 0..7 of a narrow block, 0, 128, ..., 896
    of a lane-dense one; amp rounded to float32 before the product."""
    flat = torch.arange(4096, dtype=torch.float32)
    zero = torch.zeros(2, 4096)
    for shape, words in (((4096, 1), range(8)), ((32, 128), range(0, 1024, 128))):
        a = flat.repeat(2, 1).reshape((2,) + shape)
        o = kernels.narrow_operand_sum(a, zero.reshape(a.shape), zero.reshape(a.shape), 0.1)
        want = torch.tensor(list(words), dtype=torch.float32) * np.float32(0.1)
        assert o.shape == (2, 8, 1)
        assert torch.equal(o[:, :, 0], want.repeat(2, 1))


@pytest.mark.parametrize("probe", [bf16_split_probe, lane1_blockspec_probe,
                                   mosaic_transpose_probe, multitile_roll_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_entry_points_default_to_the_card(probe):
    """Without --device a probe asks for the card, and raises where there
    is none: it never runs the plain versions unless asked to."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs the probes there")
    for run in (lambda: probe.main([]), probe.check):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_probe_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="mode"):
        kernels.bf16_split_matmul(torch.zeros(2, 2), torch.zeros(2, 2), "high")
    with pytest.raises(ValueError, match="form"):
        kernels.transpose_cols(torch.zeros(8, 8), torch.eye(8), "swapaxes")
    meta = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        kernels.narrow_operand_sum(meta, meta, meta, 1.0)
    kernels.reset_launches()
    kernels.lane_roll(torch.zeros(2, 8), 3)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
