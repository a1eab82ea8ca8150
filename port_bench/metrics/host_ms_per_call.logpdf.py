"""The mean over the traced logpdf calls of the program's host ms not blocked in a read that waits for the device (its own span, ICNFDist.logpdf)."""

from port_bench import program_spans


def read(rec):
    return program_spans.free_ms_per(rec, "logpdf.call")
