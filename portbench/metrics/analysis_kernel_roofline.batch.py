"""Kernel 1's share of its roofline: its least time on the card at the
step's shapes (portbench/roofline.py) over its device time a step."""

from portbench import roofline


def read(record):
    prof = record.get("profile")
    if record["unit"] != "step" or not prof:
        return None
    t = roofline.kernel_device_s(prof["device_ops"], "analysis") / prof["calls"]
    if t <= 0:
        return None
    s = record["shapes"]
    return 100.0 * roofline.analysis_bound_s(s["B"], s["L"], s["W"], s["T"]) / t
