"""The mean over the traced fit steps (the program's fit.step spans: the minibatch gather through the optimizer's step) of their host ms not blocked in a read that waits for the device."""

from port_bench import program_spans


def read(rec):
    return program_spans.free_ms_per(rec, "fit.step")
