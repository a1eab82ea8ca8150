"""K5 (the whole adaptive solve): the least time of the trial steps each control group took over the device seconds of its kernels."""

from port_bench import readers


def read(rec):
    return readers.roofline_pct(rec, "K5")
