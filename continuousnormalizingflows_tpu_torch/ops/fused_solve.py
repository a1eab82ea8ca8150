"""K3: the whole fixed-step RK4 solve of the augmented state in one launch.

Counterpart of ``continuousnormalizingflows_tpu.ops.pallas_solve``.  State
per row ``u = [z (nz), dlogp, E, n]``; each stage runs the fused dynamics of
:mod:`.fused_dynamics` on ``x = [z, t (non-autonomous), ys]`` and assembles
``du = [y, -div, |y|, |e_z|]``.  ``t = t0 + i*dt``, ``dt = (t1 - t0)/steps``.

:func:`fused_solve_rk4` takes the plain version for a CPU tensor and the CUDA
kernel (``csrc/fused_solve.cu``) for a CUDA tensor.  Forward only: the exact
discrete backward (K4) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ICNFConfig, Mode, TraceEstimator
from ..models.nets import MLP, Params
from . import _build
from .fused_dynamics import _ptr, _precision, kernel_operands, mlp3_forward_vjp_reference

__all__ = ["fused_solve_applicable", "fused_solve_rk4", "fused_solve_rk4_reference",
           "MAX_HIDDEN", "MAX_WIDTH"]

# the gate's range: hidden width, and net-input / state width
MAX_HIDDEN = 512
MAX_WIDTH = 128


def fused_solve_applicable(cfg: ICNFConfig, net, mode: Mode) -> bool:
    """Static preconditions for the whole-solve kernel: the JAX gate
    (``pallas_solve.fused_solve_applicable``) without its TPU-backend check,
    so the route is the same on CPU and GPU.

    Regularized train mode with both RNODE norms on (the kernel always
    integrates E and n), rk4 + backprop, one Hutchinson-VJP probe, a 3-layer
    softplus MLP with equal hidden widths <= 512 and net input and state
    widths <= 128."""
    return (
        cfg.fused
        and cfg.layout == "batch_first"
        and cfg.solver.method == "rk4"
        and cfg.solver.gradient == "backprop"
        and mode is Mode.TRAIN
        and cfg.norm_z
        and cfg.norm_j
        and cfg.trace_for(mode) is TraceEstimator.HUTCH_VJP
        and cfg.nprobes == 1
        and isinstance(net, MLP)
        and len(net.widths) == 4
        and net.widths[1] == net.widths[2]
        and net.widths[1] <= MAX_HIDDEN
        and net.activation is F.softplus
        and cfg.n_in <= MAX_WIDTH
        and cfg.state_dim <= MAX_WIDTH
    )


def _times(u0: torch.Tensor, tspan, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t0`` and ``dt = (t1 - t0)/steps`` as float32 scalars on ``u0``'s device
    (either end may be a device tensor, e.g. a steered ``t1``)."""
    t0, t1 = (torch.as_tensor(t, dtype=torch.float32, device=u0.device) for t in tspan)
    return t0, (t1 - t0) / steps


def fused_solve_rk4_reference(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                              params: Params, tspan, nz: int, t_col: Optional[int],
                              steps: int, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the whole solve: ``steps`` RK4 steps of the
    fused stage, with the kernel's rounding."""
    t0, dt = _times(u0, tspan, steps)
    b = u0.shape[0]

    def stage(t, u):
        cols = [u[:, :nz]]
        if t_col is not None:
            cols.append(t.expand(b, 1))
        if ys is not None:
            cols.append(ys.to(u.dtype))
        y, _ez, div, reg_z, reg_j = mlp3_forward_vjp_reference(
            torch.cat(cols, dim=-1), eps, params, nz, compute_dtype
        )
        return torch.cat([y, -div[:, None], reg_z[:, None], reg_j[:, None]], dim=-1)

    u = u0
    for i in range(steps):
        t = t0 + i * dt
        k1 = stage(t, u)
        k2 = stage(t + 0.5 * dt, u + 0.5 * dt * k1)
        k3 = stage(t + 0.5 * dt, u + 0.5 * dt * k2)
        k4 = stage(t + dt, u + dt * k3)
        u = u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return u


def fused_solve_rk4(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                    params: Params, tspan, nz: int, t_col: Optional[int], steps: int,
                    compute_dtype=None) -> torch.Tensor:
    """Whole-solve forward.  ``u0``: ``(B, state_dim)``; ``eps``: ``(B, nz)``;
    ``ys``: ``(B, nconditions)`` or None; ``tspan = (t0, t1)`` floats or
    scalar tensors; ``t_col``: the time column of the net input (``nz``), or
    None for an autonomous net.  Returns ``u1`` ``(B, state_dim)``."""
    if u0.device.type == "cpu":
        return fused_solve_rk4_reference(u0, eps, ys, params, tspan, nz, t_col, steps,
                                         compute_dtype)
    if u0.device.type != "cuda":
        raise ValueError(f"fused_solve_rk4 runs on CPU or CUDA tensors, got {u0.device}")
    bf16 = _precision(compute_dtype) == "default"
    t0, dt = _times(u0, tspan, steps)
    a1, b1, a2, b2, a3, b3, w1t, w2t, w3t = kernel_operands(
        params, u0.shape[1], u0, eps, ys, t0, dt)
    b, sd = u0.shape
    h, n_in, n_out = a1.shape[0], a1.shape[1], a3.shape[0]
    nc = 0 if ys is None else ys.shape[1]
    if (
        n_out != nz
        or sd != nz + 3
        or eps.shape != (b, nz)
        or (ys is not None and ys.shape[0] != b)
        or n_in != nz + (0 if t_col is None else 1) + nc
        or (t_col is not None and t_col != nz)
        or a2.shape != (h, h)
    ):
        raise ValueError(
            f"shapes do not fit the kernel: u0 {tuple(u0.shape)}, eps {tuple(eps.shape)}, "
            f"ys {None if ys is None else tuple(ys.shape)}, widths {n_in}->{h}->{n_out}, "
            f"nz={nz}, t_col={t_col}"
        )
    if h > MAX_HIDDEN or n_in > MAX_WIDTH or sd > MAX_WIDTH:
        raise ValueError(
            f"widths n_in={n_in}, h={h}, state={sd} outside the kernel's range "
            f"(h <= {MAX_HIDDEN}, n_in and state <= {MAX_WIDTH})"
        )
    u0, eps = u0.contiguous(), eps.contiguous()
    ys = None if ys is None else ys.contiguous()
    u1 = torch.empty_like(u0)
    lib = _build.kernels()
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cnf_fused_solve_rk4_fwd(
            _ptr(u0), _ptr(eps), _ptr(ys), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2),
            _ptr(a3), _ptr(b3), _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(t0), _ptr(dt), _ptr(u1),
            b, sd, n_in, h, n_out, nz, nc, -1 if t_col is None else t_col, steps,
            int(bf16), stream,
        )
    _build.check(err, "fused_solve_rk4_fwd")
    fused_solve_rk4.launches += 1
    return u1


# launches of the CUDA kernel since the last reset (a plain counter)
fused_solve_rk4.launches = 0
