"""Input audio seconds of every step completed in the window, over the
window's host seconds."""


def read(record):
    if record["unit"] != "step":
        return None
    return record["calls"] * record["work_per_call"] / record["window_s"]
