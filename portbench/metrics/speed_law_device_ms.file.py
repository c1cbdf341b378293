"""Device ms a file inside the harness's 'speed_law' span (the program's speed_law layer),
from the profiled calls: kernels, copies and sets launched while the span
was the innermost open on the host."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "file" or not prof or "speed_law" not in prof["span_device_s"]:
        return None
    return prof["span_device_s"]["speed_law"] / prof["calls"] * 1e3
