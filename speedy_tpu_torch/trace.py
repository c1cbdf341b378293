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

Graphs. GRAPHS counts the batch engine's CUDA graphs of its op chains
(parallel/graphs.py) by chain and event, as "<chain>:capture" and
"<chain>:replay" ("tension", "law", "grid"): a step on the graphed path
replays each chain once, and the step that captures a chain replays it
too.

LAUNCHES counts the port's own kernel launches (ops/kernels.py adds to it;
PyTorch's kernels are not in it). BODIES splits a kernel's launches by the
body its plan picked, as "<kernel>:<body>": kernel 1's are
"analysis_energy_lsd:fft" and "analysis_energy_lsd:direct", and while a
profiler records each of its launches runs inside a
"speedy:analysis_kernel:<body>" span. FRAMES holds, under the same keys,
kernel 1's frames computed and frames owned, [computed, owned]: a launch
owns B*T frames and computes them and, in every block but a row's first,
the frame before the block's own again (the entry point reports the
blocks a row it launched), so the recompute share is 1 - owned / computed.
PLANS counts kernel 1's launches by its plan as launched, as
"<kernel>:<body>:<W>x<F>": the window W and the frames parameter F of the
body the entry point reports it ran, which is the body's name on the card
("analysis_energy_lsd:fft:330x1" is fft_kernel<330, 1>, a team's frames a
step; "analysis_energy_lsd:direct:661x16" is direct_kernel<..., 16>, a
thread's frames). The step F is chosen in C from the grid and the card, so
only this count shows it on the host. LOAD_S is the host seconds of
ops/_build.load()'s one call, LOAD_BUILT whether that call compiled the
kernels (False: it found them built). reset() zeroes the counts, BODIES,
FRAMES, PLANS and GRAPHS among them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional

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
    "analysis_sqrt_check": 0,
}
# Launches since the last reset, by kernel and the body its plan picked.
BODIES: Dict[str, int] = {}
# Frames computed and owned since the last reset, [computed, owned], under
# BODIES' keys.
FRAMES: Dict[str, List[int]] = {}
# Launches since the last reset, by kernel, body, window and frames
# parameter, as "<kernel>:<body>:<W>x<F>".
PLANS: Dict[str, int] = {}
# Host-blocking transfers and their bytes since the last reset, by site.
SYNCS: Dict[str, int] = {}
SYNC_BYTES: Dict[str, int] = {}
# Captures and replays of the batch engine's graphs since the last reset,
# as "<chain>:capture" and "<chain>:replay".
GRAPHS: Dict[str, int] = {}
LOAD_S: Optional[float] = None
LOAD_BUILT: Optional[bool] = None

_OFF = contextlib.nullcontext()


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


def count_frames(key: str, computed: int, owned: int) -> None:
    """Add one launch's frames computed and owned to FRAMES[key]."""
    got = FRAMES.setdefault(key, [0, 0])
    got[0] += computed
    got[1] += owned


def count_plan(key: str, window: int, frames: int) -> None:
    """Add one launch of body key (BODIES' keys) at window W and frames
    parameter F to PLANS["<key>:<W>x<F>"]."""
    plan = f"{key}:{window}x{frames}"
    PLANS[plan] = PLANS.get(plan, 0) + 1


def reset() -> None:
    """Zero LAUNCHES and empty BODIES, FRAMES, PLANS, SYNCS, SYNC_BYTES and
    GRAPHS."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BODIES.clear()
    FRAMES.clear()
    PLANS.clear()
    GRAPHS.clear()
    SYNCS.clear()
    SYNC_BYTES.clear()
