"""The spread over the ranks of the gradient bucket's device ms, each train step's, averaged over the traced steps: the first rank's wait at the all-reduce for the last."""

from port_bench import readers


def read(rec):
    return readers.allreduce_skew_ms_per_step(rec)
