"""Held constants: the device copies of the constants the batch step and
the file path read (the law's scalars, the LPF's α and power tables, the
frame step, the global speed), made once and shared.

upload_once() uploads a constant once per (site, key, dtype, device)
through trace.upload, so that first call counts in trace.SYNCS[site], and
hands the same device tensor to every later call, so a warm step makes
none of those waits. It holds at most HELD_MAX tensors and HELD_MAX_BYTES
in all, dropping the least recently used; clear_held() drops them all.
held_reads() collects every tensor upload_once() hands out inside its
block, so that what keeps using one (a CUDA graph that captured it) can
hold its own reference.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Hashable, List, Optional

import torch

from . import trace

HELD_MAX = 256
HELD_MAX_BYTES = 1 << 28
_held: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()  # least recent first
_held_bytes = 0
_held_lock = threading.Lock()
_readers: List[List[torch.Tensor]] = []  # the lists of open held_reads() blocks


def upload_once(site: str, data, dtype: torch.dtype, device,
                key: Optional[Hashable] = None) -> torch.Tensor:
    """trace.upload(site, data, dtype, device) on the first call for (site,
    key, dtype, device), and the tensor that call made on every later one.
    key fixes data's value: a number is its own key by type and repr (so
    0.0 and -0.0 are two), anything else needs one. device names one
    device ("cuda:0", not "cuda"). Every caller shares the held tensor, so
    none may write to it."""
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
    if out is None:
        out = trace.upload(site, data, dtype=dtype, device=dev)
        with _held_lock:
            if k not in _held:
                _held[k] = out
                _held_bytes += out.nbytes
            while len(_held) > 1 and (len(_held) > HELD_MAX or _held_bytes > HELD_MAX_BYTES):
                _held_bytes -= _held.popitem(last=False)[1].nbytes
    for reads in _readers:
        reads.append(out)
    return out


@contextlib.contextmanager
def held_reads():
    """A list that collects every tensor upload_once() returns while the
    block runs."""
    reads: List[torch.Tensor] = []
    _readers.append(reads)
    try:
        yield reads
    finally:
        _readers.remove(reads)


def clear_held() -> None:
    """Drop every tensor upload_once() holds: the next call of each site
    uploads again."""
    global _held_bytes
    with _held_lock:
        _held.clear()
        _held_bytes = 0
