"""Fixed-step ODE integrators over tensors.

Counterpart of the fixed-step part of ``continuousnormalizingflows_tpu.ops.ode``:
``odeint(f, y0, t0, t1, args, cfg) -> (y1, SolverStats)`` with
``f(t, y, args) -> dy``.  The JAX ``lax.scan`` is a Python loop here.  The
adaptive methods (dopri5, tsit5, abm) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import SolverConfig

__all__ = ["odeint", "odeint_fixed", "SolverStats"]

ODEFunc = Callable[[Any, torch.Tensor, Any], torch.Tensor]


class SolverStats(NamedTuple):
    """Per-solve diagnostics; ``int(stats)`` is the NFE.  Fixed-step methods
    report ``naccept = steps, nreject = 0``."""

    nfe: int
    naccept: int
    nreject: int
    dt_final: torch.Tensor  # signed step size at exit

    def __int__(self) -> int:
        return int(self.nfe)


def _rk4_step(f: ODEFunc, t, y: torch.Tensor, dt, args) -> torch.Tensor:
    k1 = f(t, y, args)
    k2 = f(t + 0.5 * dt, y + dt * 0.5 * k1, args)
    k3 = f(t + 0.5 * dt, y + dt * 0.5 * k2, args)
    k4 = f(t + dt, y + dt * 1.0 * k3, args)
    return y + dt * (1 / 6) * k1 + dt * (1 / 3) * k2 + dt * (1 / 3) * k3 + dt * (1 / 6) * k4


def _euler_step(f: ODEFunc, t, y: torch.Tensor, dt, args) -> torch.Tensor:
    return y + dt * 1.0 * f(t, y, args)


def odeint_fixed(f: ODEFunc, y0: torch.Tensor, t0, t1, args,
                 cfg: SolverConfig) -> Tuple[torch.Tensor, SolverStats]:
    """``cfg.fixed_steps`` steps of rk4 or euler.  With ``cfg.remat`` and grad
    enabled each step runs under ``torch.utils.checkpoint`` (non-reentrant):
    the backward keeps only each step's input and recomputes the step's
    stages, as ``jax.checkpoint`` of the scan body does in the JAX package.
    That changes the backward's memory, not the values."""
    t0 = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device)
    t1 = torch.as_tensor(t1, dtype=y0.dtype, device=y0.device)
    n = int(cfg.fixed_steps)
    dt = (t1 - t0) / n
    step = {"rk4": _rk4_step, "euler": _euler_step}[cfg.method]
    evals = {"rk4": 4, "euler": 1}[cfg.method]
    remat = cfg.remat and torch.is_grad_enabled()
    y = y0
    for i in range(n):
        if remat:
            y = checkpoint(step, f, t0 + i * dt, y, dt, args, use_reentrant=False)
        else:
            y = step(f, t0 + i * dt, y, dt, args)
    return y, SolverStats(evals * n, n, 0, dt)


def odeint(f: ODEFunc, y0: torch.Tensor, t0, t1, args,
           cfg: SolverConfig) -> Tuple[torch.Tensor, SolverStats]:
    """Dispatch on ``cfg.method``."""
    if cfg.method in ("rk4", "euler"):
        return odeint_fixed(f, y0, t0, t1, args, cfg)
    raise NotImplementedError(
        f"method={cfg.method!r}: the adaptive solvers are not ported yet "
        "(ROADMAP.md, Queue 1: adaptive slice for dopri5/tsit5, multistep "
        "solver for abm)"
    )
