"""Routing of the PyTorch port's kernel wrappers: CPU tensors take the
plain version, tensors elsewhere or on several devices raise, and a
missing CUDA compiler raises instead of falling back."""

import numpy as np
import pytest
import torch

from speedy_tpu_torch import trace
from speedy_tpu_torch.ops import _build, kernels
from speedy_tpu_torch.ops.wsola_fast import _cola_hann


def _synth_args(device):
    B, L, K, hop = 2, 4000, 8, 160
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=device)
    return (
        t(rng.standard_normal((B, L)).astype(np.float32)),
        t(np.tile(np.arange(K, dtype=np.int32) * 400, (B, 1))),
        t(rng.uniform(0, 1, (B, K)).astype(np.float32)),
        t(_cola_hann(2 * hop)),
        t(np.ones(B, np.float32)),
        t(np.full(B, K * hop, np.int32)),
        hop,
        (K - 1) * hop,
    )


def test_cpu_tensors_take_the_plain_version():
    trace.reset()
    args = _synth_args("cpu")
    out = kernels.gather_synth(*args)
    assert torch.equal(out, kernels.gather_synth_reference(*args))
    assert trace.LAUNCHES == dict.fromkeys(trace.LAUNCHES, 0)


def test_other_devices_raise():
    meta = _synth_args("meta")
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        kernels.gather_synth(*meta)
    mixed = list(_synth_args("cpu"))
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        kernels.gather_synth(*mixed)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_cuda_errors_raise():
    class FakeLib:
        @staticmethod
        def speedy_cuda_error_string(err):
            return b"invalid argument"

    _build.check(FakeLib, "gather_synth", 0)
    with pytest.raises(RuntimeError, match="gather_synth: CUDA error 1"):
        _build.check(FakeLib, "gather_synth", 1)


def test_build_keys_on_sources():
    names = [p.name for p in _build.sources()]
    assert {"analysis.cu", "pitch.cu", "synth.cu", "gather_rows.cu", "bf16_split.cu",
            "narrow_operands.cu", "lane_roll.cu", "transpose.cu"} <= set(names)
    assert len(_build.source_hash()) == 16
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def _fake_nvcc(tmp_path, fail_on=""):
    """An nvcc stand-in: writes its -o target, prints a ptxas line, and
    fails for the source named fail_on."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'case "$*" in *"{fail_on or "@none@"}"*) echo "error in $out"; exit 1;; esac\n'
        'echo "ptxas info    : Used 8 registers"; : > "$out"\n'
    )
    script.chmod(0o755)
    return str(script)


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    lib = _build.build()
    assert lib.exists() and lib.parent.name == _build.source_hash()
    log = (lib.parent / "build.log").read_text()
    for src in _build.sources():
        assert f"{src.stem}.o {src}" in log
    assert log.count("Used 8 registers") == len(_build.sources()) + 1  # + the link
    assert _build.build() == lib  # cached by source hash


def test_build_failure_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path, "gather_rows.cu"))
    with pytest.raises(RuntimeError, match="nvcc failed for .*gather_rows.cu"):
        _build.build()
    assert not (tmp_path / "build" / _build.source_hash() / _build.LIB_NAME).exists()
