"""The program's own instruments: spans at its layer boundaries, counts of
the transfers that make the host wait for the device, the kernels' launch
counts and the time the kernels took to load.

Spans. layer(name) is a torch.profiler.record_function range named
"speedy:<name>" while a torch profiler records, and one shared null
context otherwise, so a span costs one check when no profiler runs;
traced(name) puts a whole function in one. There is no other switch: any
torch.profiler session turns the spans on, and they land in its trace
beside the device events, on the same clock.

Sync points. A copy of host data to a CUDA device without non_blocking is
a cudaMemcpyAsync from pageable memory followed by a wait for the stream,
and a read-back of a device tensor (int, float, .item(), .cpu()) waits for
the stream too. Each such site of the batch step and the single-file
pipeline goes through upload() or read_back() under a stable site name.
Each call adds one to SYNCS[site] and the bytes it moved to
SYNC_BYTES[site], on every device (so the CPU tests hold the counts), and
while a profiler records it runs inside a "speedy:sync:<site>" span, in
its layer's span.

Held constants. upload_once() uploads a constant once per (site, key,
dtype, device) and hands the same device tensor to every later call, so a
warm step makes none of those waits; each later call adds one to
HITS[site] instead of SYNCS[site]. It holds at most HELD_MAX tensors and
HELD_MAX_BYTES in all, dropping the least recently used; clear_held()
drops them all.

LAUNCHES counts the port's own kernel launches (ops/kernels.py adds to it;
PyTorch's kernels are not in it). BODIES splits a kernel's launches by the
body its plan picked, as "<kernel>:<body>": kernel 1's are
"analysis_energy_lsd:fft" and "analysis_energy_lsd:direct", and while a
profiler records each of its launches runs inside a
"speedy:analysis_kernel:<body>" span. LOAD_S is the host seconds of
ops/_build.load()'s one call, LOAD_BUILT whether that call compiled the
kernels (False: it found them built). reset() zeroes the counts, HITS
and BODIES among them, and leaves the held constants.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import OrderedDict
from typing import Dict, Hashable, Optional

import torch

PREFIX = "speedy:"
SYNC = "sync:"

# Kernel launches since the last reset, by kernel.
LAUNCHES: Dict[str, int] = {
    "analysis_energy_lsd": 0, "pitch_ssd": 0, "gather_synth": 0, "gather_rows": 0,
    "gather_rows_block": 0, "gather_rows_block_v2": 0, "gather_rows_pipelined": 0,
    "gather_rows_coalesced": 0, "bf16_split_matmul": 0, "narrow_operand_sum": 0,
    "lane_roll": 0, "transpose_cols": 0, "gather_bisect": 0, "synth_bisect": 0,
    "bisect_span_rows": 0, "speed_law": 0, "speed_law_division_check": 0,
}
# Launches since the last reset, by kernel and the body its plan picked.
BODIES: Dict[str, int] = {}
# Host-blocking transfers and their bytes since the last reset, by site.
SYNCS: Dict[str, int] = {}
SYNC_BYTES: Dict[str, int] = {}
# upload_once() calls served by a held tensor since the last reset, by site.
HITS: Dict[str, int] = {}
LOAD_S: Optional[float] = None
LOAD_BUILT: Optional[bool] = None

_OFF = contextlib.nullcontext()

HELD_MAX = 256
HELD_MAX_BYTES = 1 << 28
_held: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()  # least recent first
_held_bytes = 0
_held_lock = threading.Lock()


def layer(name: str):
    """A "speedy:<name>" profiler range while a profiler records, else a
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def traced(name: str):
    """Decorator: the function's every call inside layer(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def in_layer(*args, **kwargs):
            with layer(name):
                return fn(*args, **kwargs)

        return in_layer

    return wrap


def _count(site: str, nbytes: int) -> None:
    SYNCS[site] = SYNCS.get(site, 0) + 1
    SYNC_BYTES[site] = SYNC_BYTES.get(site, 0) + nbytes


def _elsewhere(t: torch.Tensor, device) -> bool:
    """True when as_tensor(t, device=device) copies t to another device."""
    if device is None:
        return False
    dev = torch.device(device)
    return t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index)


def upload(site: str, data, dtype: Optional[torch.dtype] = None, device=None) -> torch.Tensor:
    """torch.as_tensor(data, dtype=dtype, device=device), counted under
    site. A tensor already on device moves nothing and is not counted."""
    if isinstance(data, torch.Tensor) and not _elsewhere(data, device):
        return torch.as_tensor(data, dtype=dtype, device=device)
    with layer(SYNC + site):
        out = torch.as_tensor(data, dtype=dtype, device=device)
    _count(site, out.nbytes)
    return out


def read_back(site: str, t: torch.Tensor, convert=torch.Tensor.cpu):
    """convert(t) (Tensor.cpu by default, or int, float, ...) of a tensor
    the program made on its device, counted under site with t's bytes."""
    with layer(SYNC + site):
        out = convert(t)
    _count(site, t.nbytes)
    return out


def upload_once(site: str, data, dtype: torch.dtype, device,
                key: Optional[Hashable] = None) -> torch.Tensor:
    """upload(site, data, dtype, device) on the first call for (site, key,
    dtype, device), and the tensor that call made on every later one,
    counted in HITS[site]. key fixes data's value: a number is its own key
    by type and repr (so 0.0 and -0.0 are two), anything else needs one.
    device names one device ("cuda:0", not "cuda"). Every caller shares
    the held tensor, so none may write to it."""
    global _held_bytes
    if key is None:
        if not isinstance(data, (int, float)):
            raise TypeError(f"upload_once({site!r}): a {type(data).__name__} needs a key")
        key = (type(data), repr(data))
    dev = torch.device(device)
    k = (site, key, dtype, dev)
    with _held_lock:
        out = _held.get(k)
        if out is not None:
            _held.move_to_end(k)
            HITS[site] = HITS.get(site, 0) + 1
            return out
    out = upload(site, data, dtype=dtype, device=dev)
    with _held_lock:
        if k not in _held:
            _held[k] = out
            _held_bytes += out.nbytes
        while len(_held) > 1 and (len(_held) > HELD_MAX or _held_bytes > HELD_MAX_BYTES):
            _held_bytes -= _held.popitem(last=False)[1].nbytes
    return out


def clear_held() -> None:
    """Drop every tensor upload_once() holds: the next call of each site
    uploads again."""
    global _held_bytes
    with _held_lock:
        _held.clear()
        _held_bytes = 0


def reset() -> None:
    """Zero LAUNCHES and empty BODIES, SYNCS, SYNC_BYTES and HITS."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BODIES.clear()
    SYNCS.clear()
    SYNC_BYTES.clear()
    HITS.clear()
