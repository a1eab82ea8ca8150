"""K1: one fused dynamics stage -- MLP forward, Hutchinson probe VJP and the
per-row reductions.

Counterpart of ``continuousnormalizingflows_tpu.ops.pallas_kernels``.  For a
3-layer softplus MLP ``y = A3 sp(A2 sp(A1 x + b1) + b2) + b3`` and a probe
``eps`` it returns ``(y, e_z, div, reg_z, reg_j)`` with ``e = eps^T dy/dx``,
``e_z = e[:, :nz]``, ``div = <e_z, eps>``, ``reg_z = |y|``, ``reg_j = |e_z|``
(norms floored at ``1e-20`` under the root).

:func:`fused_dynamics_vjp` takes the plain version for a CPU tensor and the
CUDA kernel (``csrc/fused_dynamics.cu``) for a CUDA tensor.  It is a
``torch.autograd.Function`` whose backward is K2 (``csrc/fused_dynamics_bwd.cu``,
:func:`fused_dynamics_vjp_bwd`) for CUDA tensors and the plain version of K2
(:func:`fused_dynamics_vjp_bwd_reference`) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.nets import Params, _round_bf16, linear, mlp_layers
from . import _build
from ..utils import profiling

__all__ = [
    "fused_dynamics_vjp",
    "fused_dynamics_vjp_bwd",
    "fused_dynamics_vjp_bwd_reference",
    "mlp3_forward_vjp_reference",
    "MAX_HIDDEN",
]

# widest hidden layer the kernel takes (the JAX gate's bound)
MAX_HIDDEN = 1024

Out5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _precision(compute_dtype) -> str:
    if compute_dtype is None:
        return "highest"
    if compute_dtype is torch.bfloat16:
        return "default"
    raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype!r}")


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-row Euclidean norm, floored at 1e-20 under the root."""
    return torch.sqrt(torch.sum(torch.square(x), dim=-1) + 1e-20)


def mlp3_forward_vjp_reference(x: torch.Tensor, eps: torch.Tensor, params: Params,
                               nz: int, compute_dtype=None) -> Out5:
    """Plain PyTorch version of the stage, with the kernel's rounding:
    ``compute_dtype=torch.bfloat16`` rounds both operands of every product to
    bfloat16 and accumulates in float32."""
    prec = _precision(compute_dtype)
    (a1, b1), (a2, b2), (a3, b3) = mlp_layers(params)
    z1 = linear(x, a1, b1, prec)
    z2 = linear(F.softplus(z1), a2, b2, prec)
    y = linear(F.softplus(z2), a3, b3, prec)
    # the probe VJP: products with the transposed weights
    d2 = linear(eps, a3.T, None, prec) * torch.sigmoid(z2)
    d1 = linear(d2, a2.T, None, prec) * torch.sigmoid(z1)
    epsj_z = linear(d1, a1[:, :nz].T, None, prec)
    div = torch.sum(epsj_z * eps[:, :nz], dim=-1)
    return y, epsj_z, div, _row_norm(y), _row_norm(epsj_z)


Cotangents = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_dynamics_vjp_bwd_reference(x: torch.Tensor, eps: torch.Tensor, params: Params,
                                     nz: int, cotangents: Cotangents, compute_dtype=None):
    """Plain PyTorch version of K2: the cotangents of the stage's five outputs
    ``(ybar, ebar, divbar, rzbar, rjbar)`` carried back to ``x``, ``eps`` and
    the weights, by the hand chain of the TPU kernel
    (``pallas_kernels._bwd_kernel``): merged cotangents, the probe-VJP path
    with its second-order gate terms, the forward path, the weight
    gradients.  With ``compute_dtype=torch.bfloat16`` every product rounds
    both operands to bfloat16, the weight-gradient outer products included.

    Returns ``(xbar (B, n_in), epsbar (B, nz), (dA1, db1, dA2, db2, dA3,
    db3))``, the weight gradients in ``nn.Linear`` layout."""
    prec = _precision(compute_dtype)
    rnd = _round_bf16 if prec == "default" else (lambda t: t)
    (a1, b1), (a2, b2), (a3, b3) = mlp_layers(params)
    ybar, ebar, divbar, rzbar, rjbar = (c.to(torch.float32) for c in cotangents)
    divbar, rzbar, rjbar = divbar[:, None], rzbar[:, None], rjbar[:, None]
    # the forward, keeping its intermediates
    z1 = linear(x, a1, b1, prec)
    s1, h1 = torch.sigmoid(z1), F.softplus(z1)
    z2 = linear(h1, a2, b2, prec)
    s2, h2 = torch.sigmoid(z2), F.softplus(z2)
    y = linear(h2, a3, b3, prec)
    u2 = linear(eps, a3.T, None, prec)
    d2 = u2 * s2
    u1 = linear(d2, a2.T, None, prec)
    d1 = u1 * s1
    e_z = linear(d1, a1[:, :nz].T, None, prec)
    # merged cotangents of y and e_z
    ybar_t = ybar + rzbar * y / _row_norm(y)[:, None]
    ebar_t = ebar + divbar * eps[:, :nz] + rjbar * e_z / _row_norm(e_z)[:, None]
    # probe-VJP path (second-order terms)
    d1bar = linear(ebar_t, a1[:, :nz], None, prec)
    u1bar = d1bar * s1
    z1_b = d1bar * u1 * s1 * (1.0 - s1)
    d2bar = linear(u1bar, a2, None, prec)
    u2bar = d2bar * s2
    z2_b = d2bar * u2 * s2 * (1.0 - s2)
    epsbar = divbar * e_z + linear(u2bar, a3, None, prec)
    # forward path, merged with the probe path's z terms
    z2_t = linear(ybar_t, a3.T, None, prec) * s2 + z2_b
    z1_t = linear(z2_t, a2.T, None, prec) * s1 + z1_b
    xbar = linear(z1_t, a1.T, None, prec)

    def outer(g, v):  # sum over rows of g[r]^T v[r], operands rounded as a product's
        return rnd(g).T @ rnd(v)

    n_in = x.shape[1]
    wbars = (
        outer(z1_t, x) + F.pad(outer(d1, ebar_t), (0, n_in - nz)),
        z1_t.sum(0),
        outer(z2_t, h1) + outer(d2, u1bar),
        z2_t.sum(0),
        outer(ybar_t, h2) + outer(eps, u2bar),
        ybar_t.sum(0),
    )
    return xbar, epsbar, wbars


def weights_of(params: Params):
    """The six weight tensors ``A1, b1, A2, b2, A3, b3`` of a 3-layer MLP."""
    weights = [t for pair in mlp_layers(params) for t in pair]
    if len(weights) != 6:
        raise ValueError(f"the fused kernels take a 3-layer MLP, got {len(weights) // 2} layers")
    return weights


def params_of(weights) -> Params:
    """The parameter dict of the six weight tensors (inverse of :func:`weights_of`)."""
    return {f"layers.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}": w
            for i, w in enumerate(weights)}


def kernel_operands(weights, *tensors: Optional[torch.Tensor]):
    """Checks what a CUDA kernel takes -- every tensor float32 on one CUDA
    device -- and returns the six weights contiguous."""
    every = [t for t in tensors if t is not None] + list(weights)
    dev = every[0].device
    for t in every:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the fused kernels take float32, got {t.dtype}")
    return [w.contiguous() for w in weights]


def transposes(weights, staged: bool):
    """``W1t, W2t, W3t``, the transposes the products read when the kernel
    does not stage the weights in shared memory (it transposes them there),
    else ``None``."""
    if staged:
        return None, None, None
    a1, _b1, a2, _b2, a3, _b3 = weights
    return a1.t().contiguous(), a2.t().contiguous(), a3.t().contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_stage(x, eps, weights, nz):
    b, n_in = x.shape
    a1, _b1, a2, _b2, a3, _b3 = weights
    h, n_out = a1.shape[0], a3.shape[0]
    if a1.shape[1] != n_in or a2.shape != (h, h) or n_out != nz or eps.shape != (b, nz):
        raise ValueError(
            f"shapes do not fit the kernel: x {tuple(x.shape)}, eps {tuple(eps.shape)}, "
            f"widths {n_in}->{h}->{a2.shape[0]}->{n_out}, nz={nz}"
        )
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden width {h} > {MAX_HIDDEN}: outside the kernel's range")
    return b, n_in, h, n_out


def _launch_fwd(x, eps, weights, nz, compute_dtype) -> Out5:
    """K1 on CUDA tensors."""
    with profiling.span("K1"):
        bf16 = _precision(compute_dtype) == "default"
        weights = kernel_operands(weights, x, eps)
        b, n_in, h, n_out = _check_stage(x, eps, weights, nz)
        plan = _build.fwd_plan(n_in, h, n_out, nz, b)
        if plan.rows == 0:
            raise ValueError(f"widths n_in={n_in}, h={h}: one row does not fit the kernel")
        a1, b1, a2, b2, a3, b3 = weights
        w1t, w2t, w3t = transposes(weights, plan.staged or plan.path == "wide")
        x, eps = x.contiguous(), eps.contiguous()
        y = torch.empty((b, nz), dtype=torch.float32, device=x.device)
        ez = torch.empty((b, nz), dtype=torch.float32, device=x.device)
        div, reg_z, reg_j = (torch.empty((b,), dtype=torch.float32, device=x.device)
                             for _ in range(3))
        scratch = torch.empty((plan.scratch,), dtype=torch.float32, device=x.device)
        lib = _build.kernels()
        tiles = None if bf16 or plan.path != "wide" else _build.f32_tiles()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            with profiling.span("K1.call"):
                err = lib.cnf_fused_dynamics_fwd(
                    _ptr(x), _ptr(eps), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(a3), _ptr(b3),
                    _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(y), _ptr(ez),
                    _ptr(div), _ptr(reg_z), _ptr(reg_j), _ptr(scratch),
                    b, n_in, h, n_out, nz, int(bf16), stream,
                )
        _build.check(err, "fused_dynamics_fwd")
        profiling.count("K1.launches")
        if tiles is not None:  # the fp32 products on each tile (wide.f32.*)
            _build.count_f32_tiles(tiles)
        return y, ez, div, reg_z, reg_j


def split_grads(grads: torch.Tensor, n_in: int, h: int, n_out: int):
    """The kernels' flat weight gradients -> ``(dA1, db1, dA2, db2, dA3, db3)``."""
    sizes = [h * n_in, h, h * h, h, n_out * h, n_out]
    shapes = [(h, n_in), (h,), (h, h), (h,), (n_out, h), (n_out,)]
    return tuple(g.view(s) for g, s in zip(torch.split(grads, sizes), shapes))


def _launch_bwd(x, eps, weights, nz, cotangents, compute_dtype):
    """K2 on CUDA tensors."""
    with profiling.span("K2"):
        bf16 = _precision(compute_dtype) == "default"
        weights = kernel_operands(weights, x, eps, *cotangents)
        b, n_in, h, n_out = _check_stage(x, eps, weights, nz)
        shapes = [(b, nz), (b, nz), (b,), (b,), (b,)]
        if [tuple(c.shape) for c in cotangents] != shapes:
            raise ValueError(f"cotangent shapes {[tuple(c.shape) for c in cotangents]}, "
                             f"expected {shapes}")
        plan = _build.bwd_plan(n_in, h, n_out, nz, 0, b)
        if plan.rows == 0:
            raise ValueError(f"widths n_in={n_in}, h={h}: one row does not fit the kernel")
        a1, b1, a2, b2, a3, b3 = weights
        w1t, w2t, w3t = transposes(weights, plan.staged or plan.path == "wide")
        x, eps = x.contiguous(), eps.contiguous()
        ybar, ebar, divbar, rzbar, rjbar = (c.contiguous() for c in cotangents)
        xbar = torch.empty((b, n_in), dtype=torch.float32, device=x.device)
        epsbar = torch.empty((b, nz), dtype=torch.float32, device=x.device)
        partial = torch.empty((plan.grid, plan.n_params), dtype=torch.float32, device=x.device)
        scratch = torch.empty((plan.scratch,), dtype=torch.float32, device=x.device)
        grads = torch.empty((plan.n_params,), dtype=torch.float32, device=x.device)
        lib = _build.kernels()
        tiles = None if bf16 or plan.path != "wide" else _build.f32_tiles()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            with profiling.span("K2.call"):
                err = lib.cnf_fused_dynamics_bwd(
                    _ptr(x), _ptr(eps), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(a3), _ptr(b3),
                    _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(ybar), _ptr(ebar), _ptr(divbar),
                    _ptr(rzbar), _ptr(rjbar), _ptr(xbar), _ptr(epsbar), _ptr(partial),
                    _ptr(scratch), _ptr(grads), b, n_in, h, n_out, nz, int(bf16), stream,
                )
        _build.check(err, "fused_dynamics_bwd")
        profiling.count("K2.launches")
        if tiles is not None:  # the fp32 products on each tile (wide.f32.*)
            _build.count_f32_tiles(tiles)
        return xbar, epsbar, split_grads(grads, n_in, h, n_out)


def fused_dynamics_vjp_bwd(x: torch.Tensor, eps: torch.Tensor, params: Params, nz: int,
                           cotangents: Cotangents, compute_dtype=None):
    """The stage's backward: K2 for CUDA tensors, its plain version for CPU
    tensors.  Arguments and result as :func:`fused_dynamics_vjp_bwd_reference`."""
    if x.device.type == "cpu":
        return fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cotangents, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dynamics_vjp_bwd runs on CPU or CUDA tensors, got {x.device}")
    return _launch_bwd(x, eps, weights_of(params), nz, cotangents, compute_dtype)


class _FusedDynamics(torch.autograd.Function):
    """K1 forward, K2 backward.  The weights are explicit arguments so that
    autograd sees them (it does not look into a dict)."""

    @staticmethod
    def forward(ctx, x, eps, nz, compute_dtype, *weights):
        ctx.save_for_backward(x, eps, *weights)
        ctx.nz, ctx.compute_dtype = nz, compute_dtype
        if x.device.type == "cpu":
            return mlp3_forward_vjp_reference(x, eps, params_of(weights), nz, compute_dtype)
        return _launch_fwd(x, eps, weights, nz, compute_dtype)

    @staticmethod
    def backward(ctx, *cotangents):
        x, eps, *weights = ctx.saved_tensors
        xbar, epsbar, wbars = fused_dynamics_vjp_bwd(x, eps, params_of(weights), ctx.nz,
                                                     cotangents, ctx.compute_dtype)
        return (xbar, epsbar, None, None, *wbars)


def fused_dynamics_vjp(x: torch.Tensor, eps: torch.Tensor, params: Params, nz: int,
                       compute_dtype=None) -> Out5:
    """Fused MLP forward + probe VJP + reductions, differentiable.

    ``x``: ``(B, n_in)`` net input (flow state, time, conditions);
    ``eps``: ``(B, nz)`` probe; ``params``: 3-layer MLP parameter dict with
    ``n_out == nz``.  Returns ``(y (B, nz), e_z (B, nz), div, reg_z, reg_j)``.
    ``compute_dtype``: ``None`` (fp32) or ``torch.bfloat16`` (bf16 operands,
    fp32 accumulation).  CPU tensors take the plain versions of K1 and K2,
    CUDA tensors the kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dynamics_vjp runs on CPU or CUDA tensors, got {x.device}")
    _precision(compute_dtype)
    return _FusedDynamics.apply(x, eps, nz, compute_dtype, *weights_of(params))
