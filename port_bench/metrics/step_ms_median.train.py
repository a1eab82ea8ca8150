"""The median over the window's chunks of a chunk's seconds a step, in ms."""

from port_bench import readers


def read(rec):
    return readers.step_ms_median(rec)
