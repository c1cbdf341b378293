"""95th percentile (nearest rank) of all the window's step times, host
clock, each step ending in a synchronize."""

from portbench.stats import p95


def read(record):
    if record["unit"] != "step":
        return None
    return p95(record["times"]) * 1e3
