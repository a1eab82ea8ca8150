"""Seconds from the process's start to the window's: imports, the kernels' library (built on a checkout's first run), data and weights, the first train steps or the warm-up call."""


def read(rec):
    return rec["setup_s"]
