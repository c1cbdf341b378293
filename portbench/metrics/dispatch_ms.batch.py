"""Host ms from the call of SpeedupEngine.forward to its return, before the
synchronize, mean over the window's steps (profiler off)."""


def read(record):
    if record["unit"] != "step" or not record.get("dispatch"):
        return None
    return sum(record["dispatch"]) / len(record["dispatch"]) * 1e3
