"""Device kernels a step, by the profiler's count over the profiled calls."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "step" or not prof or not prof["kernel_count"]:
        return None
    return prof["kernel_count"] / prof["calls"]
