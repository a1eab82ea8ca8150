"""Dynamics, ODE solves and the CUDA kernels with their plain versions."""
