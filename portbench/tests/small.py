"""The cells at sizes a CPU test run holds: the same configurations,
traffic files and limits, with fewer and shorter inputs."""

import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = {
    "corpus16k.b128": dict(batch=8, utterance_s=4.0, kept_calls=1, warmup_calls=1),
    "corpus16k.b4096": dict(batch=8, utterance_s=4.0, kept_calls=1, warmup_calls=1),
    "file16k.nonlinear": dict(file_s=8.0, pool=4, warmup_rounds=1),
    "file16k.linear": dict(file_s=8.0, pool=4, warmup_rounds=1),
}
SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be


def run_small(workload, trace=False, seed=SEED, seconds=0.2):
    from portbench import run

    return run.run_cell(ROOT, workload, seed, seconds, trace, "cpu",
                        overrides=SMALL[workload], log=lambda *a: None)
