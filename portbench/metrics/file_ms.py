"""The window's host milliseconds over the whole files completed in it."""


def read(record):
    if record["unit"] != "file":
        return None
    return record["window_s"] / record["calls"] * 1e3
