"""Dynamics, ODE solves and the CUDA kernels with their plain versions."""

from .adjoint import odeint_diff
from .dynamics import make_augmented_dynamics, make_field
from .ode import odeint, odeint_dense, odeint_dopri5, odeint_fixed

__all__ = [
    "odeint",
    "odeint_dense",
    "odeint_dopri5",
    "odeint_fixed",
    "odeint_diff",
    "make_augmented_dynamics",
    "make_field",
]
