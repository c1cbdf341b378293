"""Seconds from the process's start to the window's start: imports, the
kernels' loading (or build), inputs, warm-up."""


def read(record):
    return record["setup_s"]
