"""The model's operations of the window's calls (NFE times one exact-trace evaluation) over the window's seconds and the fp32 peak, in percent."""

from port_bench import readers


def read(rec):
    return readers.mfu_pct(rec, readers.logpdf_flops(rec))
