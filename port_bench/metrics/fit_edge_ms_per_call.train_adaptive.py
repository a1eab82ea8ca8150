"""The mean over the traced fit calls of their host ms outside their fit.step spans and not blocked in a read: the call's prologue and epilogue, where the device has no work."""

from port_bench import program_spans


def read(rec):
    return program_spans.fit_edge_ms(rec)
