"""The 95th percentile (nearest rank) of the window's calls, each timed by the host clock to its synchronize."""

from port_bench import readers


def read(rec):
    return readers.p95_ms(rec)
