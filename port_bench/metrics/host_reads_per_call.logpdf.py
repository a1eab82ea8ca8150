"""The program's host reads (reads that wait for the device: the adaptive loop's one a trial step, and any other) inside each traced logpdf call, averaged over the calls."""

from port_bench import program_spans


def read(rec):
    return program_spans.reads_per_call(rec, "logpdf.call")
