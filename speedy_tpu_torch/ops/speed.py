"""Tension -> speed control law with duration feedback (port of
speedy_tpu/ops/speed.py).

Scalars enter the arithmetic as 0-dim float32 tensors, so every step runs
the same float32 operations as the JAX package (a Python float would be
combined in float64 first); branches are taken on the Python values, so
nothing is read back from the device. Each scalar is uploaded once per
value, dtype and device (held.upload_once) and held there, so only the
first call with a value waits for the stream. The sequential law's frame
loop is kernels.speed_law on the card (csrc/speed_law.cu, the same
operations in the same order) and kernels.speed_law_reference, a loop of
speed_law_step, as its plain version.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import config as C
from .. import held, trace
from . import kernels

# Jacobi iterations of speed_from_tension_parallel.
PARALLEL_ITERS = 8


class _Law(NamedTuple):
    fast: bool          # global_rate > 1: the speed-up branch of the law
    feedback: bool      # duration feedback on
    rg: torch.Tensor
    fb: torch.Tensor
    nl: torch.Tensor
    min_speed: torch.Tensor
    frame_duration: torch.Tensor


def _law(like: torch.Tensor, global_rate, fb, nl) -> _Law:
    f = lambda v: held.upload_once("law_scalars", float(v), like.dtype, like.device)
    return _Law(
        float(global_rate) > 1.0, float(fb) > 0.0, f(global_rate), f(fb),
        f(nl), f(C.MIN_SPEED), f(1.0 / C.FRAME_RATE_HZ),
    )


def _base_speed(law: _Law, t: torch.Tensor) -> torch.Tensor:
    """The piecewise law around R_g: >1: max(1, R_g+(1-R_g)·t);
    <=1: clamp(R_g-(1-R_g)·t, kMinimumSpeed, 1)."""
    rg = law.rg
    if law.fast:
        return torch.clamp(rg + (1.0 - rg) * t, min=1.0)
    return torch.maximum(law.min_speed, torch.clamp(rg - (1.0 - rg) * t, max=1.0))


def _with_feedback(law: _Law, base: torch.Tensor, excess: torch.Tensor):
    """speedy.c's `speed += max(kMinimumSpeed, k·excess)` when feedback is
    on (it adds at least kMinimumSpeed whenever it is)."""
    if law.feedback:
        return base + torch.maximum(law.min_speed, law.fb * excess)
    return base


def _interpolate(law: _Law, requested: torch.Tensor) -> torch.Tensor:
    """The shim's nonlinear interpolation rate·f + R_g·(1-f)."""
    return requested * law.nl + law.rg * (1.0 - law.nl)


def speed_law_step(law: _Law, cur, des, t):
    """One frame of speedyComputeSpeedFromTension (speedy.c:768-788) plus
    the shim's nonlinear interpolation (soniclib.c:342-345): durations
    integrate the feedback-adjusted, pre-interpolation speed.
    Returns (cur', des', final_speed)."""
    requested = _with_feedback(law, _base_speed(law, t), cur - des)
    cur = cur + law.frame_duration / requested
    des = des + law.frame_duration / law.rg
    return cur, des, _interpolate(law, requested)


@trace.traced("speed_law")
def speed_from_tension(
    tension: torch.Tensor,
    global_rate: float,
    duration_feedback_strength: float = 0.0,
    nonlinear_factor: float = 1.0,
    initial_durations=None,
    *,
    reference: bool = False,
):
    """Map tension [B, T] float32 to per-frame speeds [B, T], exactly as
    speedy.c:768-788, from initial_durations (a pair of [B] float32
    tensors, the durations carried in from an earlier segment; zeros by
    default). Returns (speeds, (current, desired)), the final durations [B]
    each. Frames are sequential by definition: on the card one kernel walks
    them (kernels.speed_law, the JAX package's lax.scan); reference=True,
    or CPU tensors, run the plain loop over frames."""
    law = kernels.speed_law_reference if reference else kernels.speed_law
    return law(tension.contiguous(), global_rate, duration_feedback_strength,
               nonlinear_factor, initial_durations)


@trace.traced("speed_law")
def speed_from_tension_parallel(
    tension: torch.Tensor,
    global_rate: float,
    duration_feedback_strength: float = 0.0,
    nonlinear_factor: float = 1.0,
    run_chain: Optional[Callable] = None,
) -> torch.Tensor:
    """Parallel fixed-point solver for the law, tension [B, T] -> speeds.

    Jacobi iteration: evaluate every requested speed from the previous
    iterate's excess durations, then recompute the durations with an
    exclusive prefix sum (torch.cumsum; the JAX package used a triangle
    matmul). The feedback is a contraction, so PARALLEL_ITERS (8)
    iterations reach the sequential law to float32 round-off.

    VALID ONLY FOR global_rate > 1: at sub-unity rates the kMinimumSpeed
    clamp makes the iteration expand (speedy_tpu/ops/speed.py:111-113);
    callers use speed_from_tension there.

    run_chain(fn, *inputs, static=...) runs the law, fn(tension), in the
    caller's stead: the batch engine replays it as a CUDA graph
    (parallel/graphs.py), and the speeds are then the graph's output,
    which its next replay overwrites.
    """
    if not float(global_rate) > 1.0:
        raise ValueError("the parallel speed law needs global_rate > 1")
    args = (global_rate, duration_feedback_strength, nonlinear_factor, PARALLEL_ITERS)
    if run_chain is None:
        return _parallel_law(tension, *args)
    return run_chain(lambda t: _parallel_law(t, *args), tension, static=args)


def _parallel_law(tension, global_rate, duration_feedback_strength, nonlinear_factor,
                  num_iters):
    law = _law(tension, global_rate, duration_feedback_strength, nonlinear_factor)
    base = _base_speed(law, tension)
    fd = law.frame_duration
    excess = torch.zeros_like(tension)
    for _ in range(num_iters):
        # excess entering frame k = sum_{j<k} (fd/req_j - fd/rg)
        delta = fd / _with_feedback(law, base, excess) - fd / law.rg
        excess = torch.cat(
            [torch.zeros_like(delta[..., :1]),
             torch.cumsum(delta[..., :-1], dim=-1)],
            dim=-1,
        )
    return _interpolate(law, _with_feedback(law, base, excess))
