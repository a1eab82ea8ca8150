"""K4 (the rk4 solve's exact backward): its least time on these inputs over the device seconds of the kernels launched inside its entry point."""

from port_bench import readers


def read(rec):
    return readers.roofline_pct(rec, "K4")
