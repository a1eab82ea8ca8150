"""K3 (the whole rk4 solve): its least time on these inputs over the device seconds of the kernels launched inside its entry point."""

from port_bench import readers


def read(rec):
    return readers.roofline_pct(rec, "K3")
