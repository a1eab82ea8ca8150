"""The model's operations of the window's train steps (no recompute) over the window's seconds, the chips and the fp32 peak, in percent."""

from port_bench import readers


def read(rec):
    return readers.mfu_pct(rec, readers.train_flops(rec))
