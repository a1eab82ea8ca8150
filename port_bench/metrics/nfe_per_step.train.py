"""The mean over the window's steps of the forward solve's NFE (the worst control group's), from K5's statistics."""

from port_bench import readers


def read(rec):
    return readers.nfe_per_step(rec)
