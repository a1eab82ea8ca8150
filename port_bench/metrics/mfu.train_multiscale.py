"""The chain's model operations of the window's train steps (the forward solves' fields and probe VJPs, the adjoint's stages, no recompute; port_bench/counts_multiscale.py) over the window's seconds and the fp32 peak, in percent."""

from port_bench import multiscale_readers


def read(rec):
    return multiscale_readers.mfu_pct(rec)
