"""The single-file pipeline: speedy_tpu_torch.pipeline.nonlinear_speedup
on whole int16 files held on the host, as speedy_wave's compress_sound
feeds one file a call (google/speedy speedy_wave.cc:154-242). The pool is
made in set-up; call i times file i % pool, so every run times the same
files in the same round-robin order whatever the seed."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import traffic_gen
from ..reference.plain import Plain, to_int16


class Entry:
    unit = "file"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        import speedy_tpu_torch as port
        from speedy_tpu_torch import pipeline
        from speedy_tpu_torch.ops import wsola_fast

        self.config, self.traffic, self.device = config, traffic, device
        sr = config["sample_rate"]
        self.cfg = port.SpeedyConfig(sr)
        self.pool = traffic_gen.file_pool(traffic, config, seed)
        self.files = [x for _, x in self.pool]
        self.nl = float(traffic["nonlinear_factor"])
        self.run = pipeline.nonlinear_speedup
        self.work_per_call = 1.0
        self.rng = random.Random(seed)
        self.keep = {}
        self.kept = {}
        self.lengths = []
        self.span_targets = [
            (pipeline, "_as_float", "input"),
            (pipeline, "analyze", "analysis"),
            (pipeline, "speed_from_tension", "speed_law"),
            (pipeline, "time_scale_grid", "grid_engine"),
            (pipeline, "_result", "read-back"),
        ]
        L = len(self.files[0])
        W, step, maxp, minp = int(1.5 * sr / 100), sr // 100, sr // 65, sr // 400
        G = wsola_fast.pitch_grid_stride(self.cfg)
        self.shapes = dict(B=1, L=L, W=W, T=(L - W) // step + 1, taps=maxp,
                           min_period=minp, max_period=maxp, n_grid=-(-(L + 2 * maxp) // G))

    def _speedup(self, j: int):
        c = self.config
        return self.run(self.files[j], self.cfg, c["global_speed"], self.nl,
                        c["duration_feedback_strength"], engine="grid", device=self.device)

    def call(self, i: int):
        n = len(self.files)
        j = i % n
        res = self._speedup(j)
        self.lengths.append(len(res.output))
        if self.keep.get(j) == i // n:
            self.kept[j] = res
        return None

    def warm_up(self, seconds: float) -> int:
        """Every file of the pool traffic["warmup_rounds"] times, then picks
        for each file the round whose answer is compared."""
        n = len(self.files)
        t0 = time.perf_counter()
        rounds = self.traffic["warmup_rounds"]
        for _ in range(rounds):
            for j in range(n):
                self._speedup(j)
        per_round = (time.perf_counter() - t0) / rounds
        reach = max(1, min(self.traffic["kept_within_rounds"], int(0.5 * seconds / per_round)))
        self.keep = {j: self.rng.randrange(reach) for j in range(n)}
        return rounds * n

    def finish(self, next_call: int) -> int:
        i = next_call
        while len(self.kept) < len(self.files):
            self.call(i)
            i += 1
        return i

    def outcome(self, window_calls: int) -> tuple:
        """(attempted, failed): files in the window, and those whose output
        is empty."""
        return window_calls, sum(1 for n in self.lengths[:window_calls] if n <= 0)

    def release(self) -> None:
        self.lengths = []

    def compare(self, tally, tf32_control: bool = False) -> int:
        c = self.config
        ref = Plain(c["sample_rate"], self.device)
        ctl = Plain(c["sample_rate"], self.device, tf32=True) if tf32_control else None
        for j, x in enumerate(self.files):
            args = (x, c["global_speed"], self.nl, c["duration_feedback_strength"])
            want = ref.file(*args)
            want_y = to_int16(want.output[0, : int(want.valid[0])])
            if ctl is not None:
                got = ctl.file(*args)
                got_y = to_int16(got.output[0, : int(got.valid[0])])
                got_t, got_s = got.tension, got.speeds
            else:
                res = self.kept[j]
                got_y = res.output
                got_t = torch.from_numpy(np.asarray(res.tension, np.float32))[None]
                got_s = torch.from_numpy(np.asarray(res.speeds, np.float32))[None]
            scale = lambda y: torch.from_numpy(y.astype(np.float32) / 32768.0)[None]
            tally.add(got_t, want.tension, got_s, want.speeds, scale(got_y), scale(want_y),
                      torch.tensor([len(got_y)]), torch.tensor([len(want_y)]))
        return len(self.files)
