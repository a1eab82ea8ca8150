"""One minus the device's busy seconds (the union of its kernels, copies and fills) over the traced section's seconds."""

from port_bench import readers


def read(rec):
    return readers.idle_share(rec)
