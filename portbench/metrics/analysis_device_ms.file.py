"""Device ms a file inside the harness's 'analysis' span (the program's analysis layer),
from the profiled calls: kernels, copies and sets launched while the span
was the innermost open on the host."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "file" or not prof or "analysis" not in prof["span_device_s"]:
        return None
    return prof["span_device_s"]["analysis"] / prof["calls"] * 1e3
