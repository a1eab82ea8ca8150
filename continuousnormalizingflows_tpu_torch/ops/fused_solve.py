"""K3: the whole fixed-step RK4 solve of the augmented state in one call.

Counterpart of ``continuousnormalizingflows_tpu.ops.pallas_solve``.  State
per row ``u = [z (nz), dlogp, E, n]``; each stage runs the fused dynamics of
:mod:`.fused_dynamics` on ``x = [z, t (non-autonomous), ys]`` and assembles
``du = [y, -div, |y|, |e_z|]``.  ``t = t0 + i*dt``, ``dt = (t1 - t0)/steps``.

:func:`fused_solve_rk4` takes the plain version for a CPU tensor and the CUDA
kernel (``csrc/fused_solve.cu``) for a CUDA tensor.  It is a
``torch.autograd.Function`` whose backward is K4 (``csrc/fused_solve_bwd.cu``,
:func:`fused_solve_rk4_bwd`), the exact discrete backward of the solve, for
CUDA tensors and its plain version (:func:`fused_solve_rk4_bwd_reference`)
for CPU tensors.  From a hidden width of 64 both run their wide paths
(``csrc/wide_solve.cuh``): chains of products over the whole batch, issued
from the one call, in a scratch the wrapper allocates (``_build.plan``,
``_build.bwd_plan``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ICNFConfig, Mode, TraceEstimator
from ..models.nets import MLP, Params
from . import _build
from ..utils import profiling
from .fused_dynamics import (_ptr, _precision, fused_dynamics_vjp_bwd_reference,
                             kernel_operands, mlp3_forward_vjp_reference, params_of,
                             split_grads, transposes, weights_of)

__all__ = ["fused_solve_applicable", "fused_solve_rk4", "fused_solve_rk4_reference",
           "fused_solve_rk4_bwd", "fused_solve_rk4_bwd_reference", "MAX_HIDDEN", "MAX_WIDTH"]

# the gate's range: hidden width, and net-input / state width
MAX_HIDDEN = 512
MAX_WIDTH = 128


def fused_solve_applicable(cfg: ICNFConfig, net, mode: Mode) -> bool:
    """Static preconditions for the whole-solve kernel: the JAX gate
    (``pallas_solve.fused_solve_applicable``) with a float32 check in place
    of its TPU-backend check, so the route is the same on CPU and GPU and a
    float64 config solves unfused, as JAX's does on the CPU.

    Regularized train mode with both RNODE norms on (the kernel always
    integrates E and n), rk4 + backprop, one Hutchinson-VJP probe, a 3-layer
    softplus MLP with equal hidden widths <= 512 and net input and state
    widths <= 128."""
    return (
        cfg.fused
        and cfg.dtype == torch.float32
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
    (either end may be a device tensor, e.g. a steered ``t1``).  A float end
    is copied to the card from pageable memory, which waits for the stream."""
    with profiling.host_read("solve.times"):
        t0, t1 = (torch.as_tensor(t, dtype=torch.float32, device=u0.device) for t in tspan)
    return t0, (t1 - t0) / steps


def _stage_input(t, z, ys, t_col):
    cols = [z]
    if t_col is not None:
        cols.append(t.expand(z.shape[0], 1))
    if ys is not None:
        cols.append(ys.to(z.dtype))
    return torch.cat(cols, dim=-1)


def _rk4_reference(u0, eps, ys, params, t0, dt, nz, t_col, steps, compute_dtype):
    b = u0.shape[0]

    def stage(t, u):
        y, _ez, div, reg_z, reg_j = mlp3_forward_vjp_reference(
            _stage_input(t, u[:, :nz], ys, t_col), eps, params, nz, compute_dtype
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


def fused_solve_rk4_reference(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                              params: Params, tspan, nz: int, t_col: Optional[int],
                              steps: int, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the whole solve: ``steps`` RK4 steps of the
    fused stage, with the kernel's rounding."""
    t0, dt = _times(u0, tspan, steps)
    return _rk4_reference(u0, eps, ys, params, t0, dt, nz, t_col, steps, compute_dtype)


def _rk4_bwd_reference(u0, eps, ys, params, t0, dt, nz, t_col, steps, gbar, compute_dtype):
    b, sd = u0.shape

    def k_z(t, z):  # the z columns of a stage's du
        return mlp3_forward_vjp_reference(_stage_input(t, z, ys, t_col), eps, params, nz,
                                          compute_dtype)[0]

    def stage_vjp(t, z, dub):
        cot = (dub[:, :nz], torch.zeros_like(z), -dub[:, nz], dub[:, nz + 1], dub[:, nz + 2])
        xbar, epsbar, wbars = fused_dynamics_vjp_bwd_reference(
            _stage_input(t, z, ys, t_col), eps, params, nz, cot, compute_dtype)
        return F.pad(xbar[:, :nz], (0, sd - nz)), epsbar, wbars

    # 1. the step trajectory (z columns: the accumulators never enter a stage)
    traj, z = [], u0[:, :nz]
    for i in range(steps):
        traj.append(z)
        t = t0 + i * dt
        k1 = k_z(t, z)
        k2 = k_z(t + 0.5 * dt, z + 0.5 * dt * k1)
        k3 = k_z(t + 0.5 * dt, z + 0.5 * dt * k2)
        k4 = k_z(t + dt, z + dt * k3)
        z = z + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    # 2. the steps backward through the RK4 chain rule
    a = gbar.to(torch.float32)
    epsbar = torch.zeros_like(eps)
    wbars = [torch.zeros_like(w) for w in weights_of(params)]
    for n in reversed(range(steps)):
        u = traj[n]
        t = t0 + n * dt
        v1 = u + 0.5 * dt * k_z(t, u)
        v2 = u + 0.5 * dt * k_z(t + 0.5 * dt, v1)
        v3 = u + dt * k_z(t + 0.5 * dt, v2)
        v3b, e4, w4 = stage_vjp(t + dt, v3, (dt / 6.0) * a)
        v2b, e3, w3 = stage_vjp(t + 0.5 * dt, v2, (dt / 3.0) * a + dt * v3b)
        v1b, e2, w2 = stage_vjp(t + 0.5 * dt, v1, (dt / 3.0) * a + 0.5 * dt * v2b)
        u0b, e1, w1 = stage_vjp(t, u, (dt / 6.0) * a + 0.5 * dt * v1b)
        a = a + v3b + v2b + v1b + u0b
        epsbar = epsbar + e1 + e2 + e3 + e4
        wbars = [acc + c4 + c3 + c2 + c1 for acc, c4, c3, c2, c1 in zip(wbars, w4, w3, w2, w1)]
    return a, epsbar, tuple(wbars)


def fused_solve_rk4_bwd_reference(u0: torch.Tensor, eps: torch.Tensor,
                                  ys: Optional[torch.Tensor], params: Params, tspan, nz: int,
                                  t_col: Optional[int], steps: int, gbar: torch.Tensor,
                                  compute_dtype=None):
    """Plain PyTorch version of K4, the exact discrete backward of the solve
    (``pallas_solve._solve_bwd_kernel``): recompute the step trajectory, then
    walk the RK4 steps backward with the stage VJP of
    :func:`.fused_dynamics.fused_dynamics_vjp_bwd_reference`.

    ``gbar``: the cotangent of ``u1``.  Returns ``(u0bar (B, state_dim),
    epsbar (B, nz), (dA1, db1, dA2, db2, dA3, db3))``.  The cotangents of
    ``ys`` and of the time span are not computed, as in the TPU kernel."""
    t0, dt = _times(u0, tspan, steps)
    return _rk4_bwd_reference(u0, eps, ys, params, t0, dt, nz, t_col, steps, gbar,
                              compute_dtype)


def _check_solve(u0, eps, ys, weights, nz, t_col):
    b, sd = u0.shape
    a1, _b1, a2, _b2, a3, _b3 = weights
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
    return b, sd, n_in, h, n_out, nc


def _launch_fwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, compute_dtype):
    """K3 on CUDA tensors."""
    with profiling.span("K3"):
        bf16 = _precision(compute_dtype) == "default"
        weights = kernel_operands(weights, u0, eps, ys, t0, dt)
        b, sd, n_in, h, n_out, nc = _check_solve(u0, eps, ys, weights, nz, t_col)
        plan = _build.plan(n_in, h, n_out, n_out, sd, b)
        if plan.rows == 0:
            raise ValueError(f"widths n_in={n_in}, h={h}: one row does not fit the kernel")
        a1, b1, a2, b2, a3, b3 = weights
        w1t, w2t, w3t = transposes(weights, plan.staged or plan.path == "wide")
        u0, eps = u0.contiguous(), eps.contiguous()
        ys = None if ys is None else ys.contiguous()
        u1 = torch.empty_like(u0)
        scratch = torch.empty((plan.scratch,), dtype=torch.float32, device=u0.device)
        lib = _build.kernels()
        tiles = None if bf16 or plan.path != "wide" else _build.f32_tiles()
        with torch.cuda.device(u0.device):
            stream = torch.cuda.current_stream().cuda_stream
            with profiling.span("K3.call"):
                err = lib.cnf_fused_solve_rk4_fwd(
                    _ptr(u0), _ptr(eps), _ptr(ys), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2),
                    _ptr(a3), _ptr(b3), _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(t0), _ptr(dt),
                    _ptr(u1), _ptr(scratch), b, sd, n_in, h, n_out, nz, nc,
                    -1 if t_col is None else t_col, steps, int(bf16), stream,
                )
        _build.check(err, "fused_solve_rk4_fwd")
        profiling.count("K3.launches")
        if tiles is not None:  # the fp32 products on each tile (wide.f32.*)
            _build.count_f32_tiles(tiles)
        return u1


def _launch_bwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, gbar, compute_dtype):
    """K4 on CUDA tensors."""
    with profiling.span("K4"):
        bf16 = _precision(compute_dtype) == "default"
        weights = kernel_operands(weights, u0, eps, ys, t0, dt, gbar)
        b, sd, n_in, h, n_out, nc = _check_solve(u0, eps, ys, weights, nz, t_col)
        if gbar.shape != u0.shape:
            raise ValueError(f"cotangent shape {tuple(gbar.shape)}, expected {tuple(u0.shape)}")
        plan = _build.bwd_plan(n_in, h, n_out, nz, sd, b)
        if plan.rows == 0:
            raise ValueError(f"widths n_in={n_in}, h={h}: one row does not fit the kernel")
        a1, b1, a2, b2, a3, b3 = weights
        w1t, w2t, w3t = transposes(weights, plan.staged or plan.path == "wide")
        u0, eps, gbar = u0.contiguous(), eps.contiguous(), gbar.contiguous()
        ys = None if ys is None else ys.contiguous()
        dev = u0.device
        u0bar = torch.empty_like(u0)
        epsbar = torch.empty_like(eps)
        # scratch of the step trajectory, steps x B x nz floats in the layout of the path
        traj = torch.empty((steps * b * nz,), dtype=torch.float32, device=dev)
        partial = torch.empty((plan.grid, plan.n_params), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.scratch,), dtype=torch.float32, device=dev)
        grads = torch.empty((plan.n_params,), dtype=torch.float32, device=dev)
        lib = _build.kernels()
        tiles = None if bf16 or plan.path != "wide" else _build.f32_tiles()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            with profiling.span("K4.call"):
                err = lib.cnf_fused_solve_rk4_bwd(
                    _ptr(u0), _ptr(eps), _ptr(ys), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2),
                    _ptr(a3), _ptr(b3), _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(t0), _ptr(dt),
                    _ptr(gbar), _ptr(u0bar), _ptr(epsbar), _ptr(traj), _ptr(partial),
                    _ptr(scratch), _ptr(grads), b, sd, n_in, h, n_out, nz, nc,
                    -1 if t_col is None else t_col, steps, int(bf16), stream,
                )
        _build.check(err, "fused_solve_rk4_bwd")
        profiling.count("K4.launches")
        if tiles is not None:  # the fp32 products on each tile (wide.f32.*)
            _build.count_f32_tiles(tiles)
        return u0bar, epsbar, split_grads(grads, n_in, h, n_out)


def _bwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, gbar, compute_dtype):
    if u0.device.type == "cpu":
        return _rk4_bwd_reference(u0, eps, ys, params_of(weights), t0, dt, nz, t_col, steps,
                                  gbar, compute_dtype)
    return _launch_bwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, gbar, compute_dtype)


def fused_solve_rk4_bwd(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                        params: Params, tspan, nz: int, t_col: Optional[int], steps: int,
                        gbar: torch.Tensor, compute_dtype=None):
    """The solve's backward: K4 for CUDA tensors, its plain version for CPU
    tensors.  Arguments and result as :func:`fused_solve_rk4_bwd_reference`."""
    if u0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_solve_rk4_bwd runs on CPU or CUDA tensors, got {u0.device}")
    t0, dt = _times(u0, tspan, steps)
    return _bwd(u0, eps, ys, weights_of(params), t0, dt, nz, t_col, steps, gbar, compute_dtype)


class _FusedSolve(torch.autograd.Function):
    """K3 forward, K4 backward, with the cotangent structure of the JAX rule
    (``pallas_solve._fused_solve_bwd``): ``u0``, ``eps`` and the six weights
    get real cotangents.  ``ys`` gets zeros: like the TPU kernel, K4 does not
    carry the cotangent of the conditions.  ``t0`` and ``dt`` get none: the
    steered end time is not differentiated, in the reference either."""

    @staticmethod
    def forward(ctx, u0, eps, ys, t0, dt, nz, t_col, steps, compute_dtype, *weights):
        ctx.save_for_backward(u0, eps, ys, t0, dt, *weights)
        ctx.static = (nz, t_col, steps, compute_dtype)
        if u0.device.type == "cpu":
            return _rk4_reference(u0, eps, ys, params_of(weights), t0, dt, nz, t_col, steps,
                                  compute_dtype)
        return _launch_fwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, compute_dtype)

    @staticmethod
    def backward(ctx, gbar):
        u0, eps, ys, t0, dt, *weights = ctx.saved_tensors
        nz, t_col, steps, compute_dtype = ctx.static
        u0bar, epsbar, wbars = _bwd(u0, eps, ys, weights, t0, dt, nz, t_col, steps, gbar,
                                    compute_dtype)
        ysbar = None if ys is None else torch.zeros_like(ys)
        return (u0bar, epsbar, ysbar, None, None, None, None, None, None, *wbars)


def fused_solve_rk4(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                    params: Params, tspan, nz: int, t_col: Optional[int], steps: int,
                    compute_dtype=None) -> torch.Tensor:
    """Whole-solve forward, differentiable.  ``u0``: ``(B, state_dim)``;
    ``eps``: ``(B, nz)``; ``ys``: ``(B, nconditions)`` or None;
    ``tspan = (t0, t1)`` floats or scalar tensors; ``t_col``: the time column
    of the net input (``nz``), or None for an autonomous net.  Returns ``u1``
    ``(B, state_dim)``."""
    if u0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_solve_rk4 runs on CPU or CUDA tensors, got {u0.device}")
    _precision(compute_dtype)
    t0, dt = _times(u0, tspan, steps)
    return _FusedSolve.apply(u0, eps, ys, t0, dt, nz, t_col, steps, compute_dtype,
                             *weights_of(params))
