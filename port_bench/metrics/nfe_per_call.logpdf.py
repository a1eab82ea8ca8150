"""The mean over the window's calls of the solve's NFE, from the solver statistics the entry returned."""

from port_bench import readers


def read(rec):
    return (lambda n: None if n is None else sum(n) / len(n))(readers.solve_nfes(rec))
