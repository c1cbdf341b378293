"""Device ms a step of kernel 1's FFT body (csrc/analysis.cu's
fft_kernel<W, F>, the body fft_plan picks where W has an FFT plan, as
22.05 kHz's W = 330 in steps of F = 1 frame), from the profiled steps'
kernels by name; None without a profile or where no step ran that body.
The program runs each such launch inside its "speedy:analysis_kernel:fft"
span and counts it in trace.BODIES["analysis_energy_lsd:fft"] and, by the
W and F of the kernel's name, in trace.PLANS["analysis_energy_lsd:fft:<W>x<F>"]."""

import re

FFT = re.compile(r"(^|\W)fft_kernel\W")


def read(record):
    prof = record.get("profile")
    if record["unit"] != "step" or not prof:
        return None
    s = sum(t for name, t in prof["device_ops"].items() if FFT.search(name + " "))
    if s <= 0:
        return None
    return s / prof["calls"] * 1e3
