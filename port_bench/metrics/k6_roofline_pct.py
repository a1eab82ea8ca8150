"""K6 (the adaptive solve's exact backward): the least time of six stage forwards and backwards a group's accepted step over the device seconds of its kernels."""

from port_bench import readers


def read(rec):
    return readers.roofline_pct(rec, "K6")
