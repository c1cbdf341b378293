"""Device ms a step of kernel 1's direct-sum body (csrc/analysis.cu's
direct_kernel, the body fft_plan picks where W has no FFT plan, as 44.1
kHz's W = 661), from the profiled steps' kernels by name; None without a
profile or where no step ran that body."""

import re

DIRECT = re.compile(r"(^|\W)direct_kernel\W")


def read(record):
    prof = record.get("profile")
    if record["unit"] != "step" or not prof:
        return None
    s = sum(t for name, t in prof["device_ops"].items() if DIRECT.search(name + " "))
    if s <= 0:
        return None
    return s / prof["calls"] * 1e3
