"""The port's launch path (ops/kernels.py::_launch, ops/_build.py::load)
and the C entry points' shared-memory grants, on the CPU: no nvcc and no
card here, so the library and the stream lookup are fakes, and the grants
are checked in the sources."""

import pathlib
import re

import pytest
import torch

from speedy_tpu_torch.ops import _build, kernels

CSRC = pathlib.Path(_build.__file__).resolve().parent.parent / "csrc"
# The C entry points whose kernels take dynamic shared memory above the
# default 48 KB, and so must grant it.
GRANTING_SOURCES = ("analysis.cu", "pitch.cu", "narrow_operands.cu", "gather_pipelined.cu",
                    "gather_block.cu", "gather_coalesced.cu", "bf16_split.cu", "synth.cu")
STREAM = 0x5EED


def c_entry_points() -> set:
    return {name for src in CSRC.glob("*.cu")
            for name in re.findall(r'extern "C" int (speedy_\w+)\(', src.read_text())}


class FakeLibrary:
    """Stands in for the CDLL: an attribute for every entry point, and the
    error string."""

    def __init__(self, names):
        for name in names:
            setattr(self, name, type("Fn", (), {})())

    @staticmethod
    def speedy_cuda_error_string(err):
        return f"fake error {err}".encode()


@pytest.fixture
def bound_table(monkeypatch):
    """_build.load() over a FakeLibrary, with the cache cleared around it."""
    monkeypatch.setattr(_build, "_library", lambda: FakeLibrary(_build._SIGNATURES))
    _build.load.cache_clear()
    yield _build.load()
    _build.load.cache_clear()


def test_bound_table_covers_every_entry_point(bound_table):
    names = {"speedy_" + name for name in bound_table}
    assert names == set(_build._SIGNATURES)
    assert names == c_entry_points()
    assert set(bound_table) == set(kernels.LAUNCHES)


def test_bound_table_sets_each_signature(bound_table):
    for name, fn in bound_table.items():
        assert fn.argtypes == _build._SIGNATURES["speedy_" + name]
        assert fn.restype is _build.ctypes.c_int
        assert fn.argtypes[-1] is _build.ctypes.c_void_p  # the stream


class FakeEntry:
    def __init__(self, ret=0):
        self.calls, self.ret = [], ret

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.fixture
def fake_launch(monkeypatch):
    """_launch with a fake entry point for lane_roll, device 0 current, and
    the stream lookup returning STREAM; records the device contexts
    entered."""
    entry = FakeEntry()
    contexts = []

    class Context:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            contexts.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "load", lambda: {"lane_roll": entry})
    monkeypatch.setattr(_build, "_library", lambda: FakeLibrary(()))
    monkeypatch.setattr(kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: STREAM + index)
    monkeypatch.setattr(torch.cuda, "device", Context)
    kernels.reset_launches()
    yield entry, contexts
    kernels.reset_launches()


def test_launch_passes_arguments_then_the_stream(fake_launch):
    entry, contexts = fake_launch
    kernels._launch("lane_roll", torch.device("cuda", 0), 11, 22, 64, 512, 266)
    assert entry.calls == [(11, 22, 64, 512, 266, STREAM)]
    assert contexts == []  # the tensor's device is the current one


def test_launch_on_another_device_enters_its_context(fake_launch):
    entry, contexts = fake_launch
    kernels._launch("lane_roll", torch.device("cuda", 1), 11, 22, 64, 512, 266)
    assert contexts == [1]
    assert entry.calls == [(11, 22, 64, 512, 266, STREAM + 1)]
    assert kernels.LAUNCHES["lane_roll"] == 1


def test_launch_counts_one_on_success(fake_launch):
    for n in (1, 2):
        kernels._launch("lane_roll", torch.device("cuda", 0), 1, 2, 3, 4, 5)
        assert kernels.LAUNCHES["lane_roll"] == n
    assert sum(kernels.LAUNCHES.values()) == 2


def test_launch_raises_on_an_error_and_counts_nothing(fake_launch):
    entry, _ = fake_launch
    entry.ret = 98  # cudaErrorInvalidDeviceFunction
    with pytest.raises(RuntimeError, match=r"lane_roll: CUDA error 98 \(fake error 98\)"):
        kernels._launch("lane_roll", torch.device("cuda", 0), 1, 2, 3, 4, 5)
    assert len(entry.calls) == 1
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_no_entry_point_grants_shared_memory_itself():
    """cudaFuncSetAttribute appears only in the once-only helper."""
    direct = [p.name for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]
              if "cudaFuncSetAttribute(" in p.read_text() and p.name != "shared_grant.cuh"]
    assert direct == []


@pytest.mark.parametrize("source", GRANTING_SOURCES)
def test_entry_point_grants_through_the_helper(source):
    text = (CSRC / source).read_text()
    assert '#include "shared_grant.cuh"' in text
    assert "speedy::grant_shared_bytes(" in text


def test_grant_helper_keeps_a_high_water_mark():
    """The helper keys its grants on kernel and device and calls
    cudaFuncSetAttribute again only for more bytes than were granted."""
    text = (CSRC / "shared_grant.cuh").read_text()
    assert text.count("cudaFuncSetAttribute(") == 1
    assert "cudaGetDevice(" in text
    assert re.search(r"g->bytes >= bytes\) return cudaSuccess", text)
