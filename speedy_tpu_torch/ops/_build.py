"""Build and load the port's CUDA kernels.

Every `speedy_tpu_torch/csrc/*.cu` (with the `*.cuh` headers beside them)
is compiled by nvcc, at first use, into one shared library with a plain C
interface, which ctypes loads. Each source compiles in its own nvcc
process, all started together, and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -shared -o libspeedy_kernels.so *.o

The library lands in `speedy_tpu_torch/_build/<hash>/`, keyed on a hash of
the sources, headers and flags, so an edited source rebuilds and an unchanged one is
loaded as it is; the compiler's output (ptxas' registers and shared memory
per kernel) is kept beside it in build.log. There is no fallback: a missing
nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libspeedy_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: argument types, all returning a cudaError_t as int.
_SIGNATURES = {
    "speedy_analysis_energy_lsd": [_P] * 7 + [_I] * 5 + [_F, _P],
    "speedy_pitch_ssd": [_P] * 3 + [_I] * 7 + [_P],
    "speedy_gather_synth": [_P] * 7 + [_I] * 5 + [_P],
    "speedy_gather_rows": [_P] * 4 + [_I] * 4 + [_P],
    "speedy_gather_rows_block": [_P] * 4 + [_I] * 6 + [_P],
    "speedy_gather_rows_block_v2": [_P] * 4 + [_I] * 6 + [_P],
    "speedy_gather_rows_pipelined": [_P] * 3 + [_I] * 4 + [_P],
    "speedy_gather_rows_coalesced": [_P] * 4 + [_I] * 5 + [_P],
    "speedy_bf16_split_matmul": [_P] * 3 + [_I] * 4 + [_P],
    "speedy_narrow_operand_sum": [_P] * 4 + [_I] * 3 + [_F, _P],
    "speedy_lane_roll": [_P] * 2 + [_I] * 3 + [_P],
    "speedy_transpose_cols": [_P] * 3 + [_I] * 3 + [_P],
    "speedy_gather_bisect": [_P] * 4 + [_I] * 8 + [_P],
    "speedy_synth_bisect": [_P] * 6 + [_I] * 9 + [_P],
    "speedy_bisect_span_rows": [_P] * 5 + [_I] * 7 + [_P],
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (no CUDA_HOME and none on PATH): the CUDA "
            "kernels cannot be built"
        )
    return path


def build() -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename the library into place: a
    # concurrent build of the same hash then never loads a half-written one.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        cmds = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for src, obj in zip(sources(), objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for cmd in cmds
        ]
        outs = [proc.communicate()[0] for proc in procs]  # waits for every one
        log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
        failed = [cmd[-1] for cmd, proc in zip(cmds, procs) if proc.returncode != 0]
        if not failed:
            link = [nvcc, "-shared", "-o", os.path.join(tmp, LIB_NAME), *objs]
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log += " ".join(link) + "\n" + proc.stdout
            if proc.returncode != 0:
                failed = ["link"]
        (out_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        os.replace(os.path.join(tmp, LIB_NAME), lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.speedy_cuda_error_string.argtypes = [ctypes.c_int]
    lib.speedy_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.speedy_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
