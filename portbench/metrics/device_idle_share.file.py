"""Percent of the profiled window in which no operation ran on the device:
1 - busy / window, both from the same profiled files."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "file" or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
