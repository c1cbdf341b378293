"""95th percentile (nearest rank) of all the window's file times, host
clock."""

from portbench.stats import p95


def read(record):
    if record["unit"] != "file":
        return None
    return p95(record["times"]) * 1e3
