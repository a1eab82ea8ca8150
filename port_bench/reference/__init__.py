"""The plain PyTorch reference of the benchmark: imports nothing but torch."""
