"""Device ms of host-to-device copies a file, from the profiled calls."""


def read(record):
    prof = record.get("profile")
    if record["unit"] != "file" or not prof or "HtoD" not in prof["copies_s"]:
        return None
    return prof["copies_s"]["HtoD"] / prof["calls"] * 1e3
