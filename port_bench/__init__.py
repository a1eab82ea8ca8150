"""The benchmark of the PyTorch/H100 port (``continuousnormalizingflows_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``control.py`` gives the
readings that a cell's correctness limits are set from.  See ``harness.py``
for how a cell's files are found by name.
"""
