"""The batch engine: speedy_tpu_torch.SpeedupEngine.forward on B rows that
stay on the device, one gain vector a step from a bank drawn from the seed
(step i takes bank[i % bank]), each step ending in a synchronize."""

from __future__ import annotations

import random
import time

import torch

from .. import traffic_gen
from ..reference.plain import Plain


class Entry:
    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        import speedy_tpu_torch as port
        from speedy_tpu_torch.ops import wsola_fast
        from speedy_tpu_torch.parallel import batch

        self.config, self.traffic, self.device = config, traffic, device
        sr = config["sample_rate"]
        self.xs = traffic_gen.batch_rows(traffic, config, device)
        self.B, self.L = self.xs.shape
        self.lengths = torch.full((self.B,), self.L, dtype=torch.int32, device=device)
        self.bank = traffic_gen.gain_bank(traffic, seed, device)
        self.gains = list(self.bank.unbind(0))
        self.engine = port.SpeedupEngine(
            port.SpeedyConfig(sr), config["global_speed"], config["nonlinear_factor"],
            config["duration_feedback_strength"], capacity_factor=config["capacity_factor"],
        ).to(device)
        self.capacity = port.grid_output_capacity(
            port.SpeedyConfig(sr), self.L, config["global_speed"], config["capacity_factor"])
        self.work_per_call = self.B * self.L / sr  # audio seconds
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.rng = random.Random(seed)
        self.keep = set()
        self.kept = {}
        self.valid = []
        self.span_targets = [
            (batch, "batched_analysis", "analysis"),
            (batch, "speed_from_tension_parallel", "speed_law"),
            (batch, "speed_from_tension", "speed_law"),
            (wsola_fast, "wsola_grid_batch", "grid_engine"),
        ]
        W = int(1.5 * sr / 100)
        step = sr // 100
        maxp, minp = sr // 65, sr // 400
        G = wsola_fast.pitch_grid_stride(port.SpeedyConfig(sr))
        self.shapes = dict(B=self.B, L=self.L, W=W, T=(self.L - W) // step + 1,
                           taps=maxp, min_period=minp, max_period=maxp,
                           n_grid=-(-(self.L + 2 * maxp) // G))

    def call(self, i: int):
        """Step i; returns the host seconds until forward returned."""
        t0 = time.perf_counter()
        res = self.engine(self.xs, self.lengths, self.gains[i % len(self.gains)])
        dispatch = time.perf_counter() - t0
        self.sync()
        self.valid.append(res.valid_length)
        if i in self.keep:
            self.kept[i] = res
        return dispatch

    def warm_up(self, seconds: float) -> int:
        """At least traffic["warmup_calls"] steps, holding as many results at
        once as the window will keep, so that the window allocates nothing
        new; then picks the steps whose answers are compared. Returns the
        number of calls made."""
        n_keep = self.traffic["kept_calls"]
        held = []
        n = self.traffic["warmup_calls"]
        t0 = time.perf_counter()
        for i in range(n):
            held.append(self.engine(self.xs, self.lengths, self.gains[i % len(self.gains)]))
            held = held[-n_keep:]
            self.sync()
        per_call = (time.perf_counter() - t0) / n
        del held
        self.valid.clear()
        reach = max(n_keep, min(self.traffic["kept_within"], int(0.5 * seconds / per_call)))
        self.keep = set(self.rng.sample(range(reach), n_keep))
        return n

    def finish(self, next_call: int) -> int:
        """Runs the kept steps the window did not reach, untimed; returns the
        next call index."""
        i = next_call
        while not self.keep.issubset(self.kept):
            self.call(i)
            i += 1
        return i

    def outcome(self, window_calls: int) -> tuple:
        """(attempted, failed) over the window's steps: utterances whose
        valid_length reached capacity or is 0, and kept rows whose output is
        not finite."""
        v = torch.stack(self.valid[:window_calls])
        failed = int(((v >= self.capacity) | (v <= 0)).sum())
        for res in self.kept.values():
            failed += int((~torch.isfinite(res.output).all(dim=1)).sum())
        return window_calls * self.B, failed

    def release(self) -> None:
        """Drops the program's state but the kept answers and the inputs."""
        self.engine = None
        self.valid = []

    def compare(self, tally, tf32_control: bool = False) -> int:
        """Every kept step's rows against the reference, in blocks; with
        tf32_control the reference in TF32 stands in for the program.
        Returns the number of answers compared."""
        c = self.config
        ref = Plain(c["sample_rate"], self.device)
        ctl = Plain(c["sample_rate"], self.device, tf32=True) if tf32_control else None
        rows = 0
        step = self.traffic.get("compare_rows", 256)
        for i in sorted(self.keep):
            res, g = self.kept[i], self.gains[i % len(self.gains)]
            for r0 in range(0, self.B, step):
                sl = slice(r0, r0 + step)
                args = (self.xs[sl], g[sl], c["global_speed"], c["nonlinear_factor"],
                        c["duration_feedback_strength"], c["capacity_factor"])
                want = ref.batch(*args)
                got = ctl.batch(*args) if ctl else _as_reference(res, sl)
                tally.add(got.tension, want.tension, got.speeds, want.speeds,
                          got.output, want.output, got.valid, want.valid)
                rows += want.valid.shape[0]
        return rows


def _as_reference(res, sl):
    from ..reference.plain import Result

    return Result(res.tension[sl], res.speeds[sl], res.output[sl], res.valid_length[sl])
