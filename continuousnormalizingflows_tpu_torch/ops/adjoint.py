"""Differentiable ODE solve, dispatching on ``cfg.gradient``.

Counterpart of ``continuousnormalizingflows_tpu.ops.adjoint.odeint_diff``.
Only ``backprop`` (discretize-then-optimize: autograd through the fixed-step
loop) is ported; the backsolve and quadrature adjoints raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SolverConfig
from .ode import SolverStats, odeint

__all__ = ["odeint_diff"]


def odeint_diff(f, y0: torch.Tensor, t0, t1, args,
                cfg: SolverConfig) -> Tuple[torch.Tensor, SolverStats]:
    if cfg.gradient == "backprop":
        return odeint(f, y0, t0, t1, args, cfg)
    raise NotImplementedError(
        f"gradient={cfg.gradient!r}: the continuous adjoints are not ported yet "
        "(ROADMAP.md, Queue 1: adaptive slice)"
    )
