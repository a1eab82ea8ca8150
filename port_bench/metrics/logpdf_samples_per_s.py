"""Rows scored over the window's seconds, by the host clock."""

from port_bench import readers


def read(rec):
    return readers.rate(rec)
