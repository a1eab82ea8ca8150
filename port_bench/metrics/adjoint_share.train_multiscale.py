"""The device seconds of the continuous adjoint's backward solves (ops/adjoint._backward_solve, which holds the program's adjoint.backward span), each timed by CUDA events on its stream at its start and its return, over the traced section's busy device seconds."""

from port_bench import multiscale_readers


def read(rec):
    return multiscale_readers.adjoint_share(rec)
