"""Device ms a train step in the gradient bucket's span (pack, NCCL all-reduce, unpack) on the rank that waits least there, each step's, averaged over the traced steps."""

from port_bench import readers


def read(rec):
    return readers.allreduce_ms_per_step(rec)
