"""Device ms a file inside the harness's 'grid_engine' span (the program's grid_engine layer),
from the profiled calls: kernels, copies and sets launched while the span
was the innermost open on the host."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "file" or not prof or "grid_engine" not in prof["span_device_s"]:
        return None
    return prof["span_device_s"]["grid_engine"] / prof["calls"] * 1e3
