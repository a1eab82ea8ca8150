"""K1: one fused dynamics stage -- MLP forward, Hutchinson probe VJP and the
per-row reductions.

Counterpart of ``continuousnormalizingflows_tpu.ops.pallas_kernels``.  For a
3-layer softplus MLP ``y = A3 sp(A2 sp(A1 x + b1) + b2) + b3`` and a probe
``eps`` it returns ``(y, e_z, div, reg_z, reg_j)`` with ``e = eps^T dy/dx``,
``e_z = e[:, :nz]``, ``div = <e_z, eps>``, ``reg_z = |y|``, ``reg_j = |e_z|``
(norms floored at ``1e-20`` under the root).

:func:`fused_dynamics_vjp` takes the plain version for a CPU tensor and the
CUDA kernel (``csrc/fused_dynamics.cu``) for a CUDA tensor.  The kernel is
forward-only: its backward (K2) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.nets import Params, linear, mlp_layers
from . import _build

__all__ = [
    "fused_dynamics_vjp",
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


def kernel_operands(params: Params, sd: int, *tensors: torch.Tensor):
    """Checks what a CUDA kernel takes and returns its nine weight operands:
    ``A1, b1, A2, b2, A3, b3`` in ``nn.Linear`` layout and the transposes
    ``W1t, W2t, W3t`` the forward products read -- ``None`` when the kernel
    stages the weights in shared memory (it transposes them there).  ``sd``:
    the whole-solve kernel's state width, 0 for the single stage.

    Every tensor must be float32 on one CUDA device.  Gradients are not
    supported yet: a call that autograd would record raises."""
    weights = [t for pair in mlp_layers(params) for t in pair]
    if len(weights) != 6:
        raise ValueError(f"the fused kernels take a 3-layer MLP, got {len(weights) // 2} layers")
    every = [t for t in tensors if t is not None] + weights
    dev = every[0].device
    for t in every:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the fused kernels take float32, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in every):
        raise NotImplementedError(
            "the CUDA fused kernels are forward-only; their backward kernels "
            "(K2, K4) come with the training slice (ROADMAP.md, Queue 1: "
            "training slice). Run under torch.no_grad() or on CPU tensors."
        )
    a1, b1, a2, b2, a3, b3 = (w.contiguous() for w in weights)
    h, n_in, n_out = a1.shape[0], a1.shape[1], a3.shape[0]
    _rows, staged, _h_pad = _build.plan(n_in, h, n_out, n_out, sd)
    if staged:
        return a1, b1, a2, b2, a3, b3, None, None, None
    return a1, b1, a2, b2, a3, b3, a1.t().contiguous(), a2.t().contiguous(), a3.t().contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_dynamics_vjp(x: torch.Tensor, eps: torch.Tensor, params: Params, nz: int,
                       compute_dtype=None) -> Out5:
    """Fused MLP forward + probe VJP + reductions.

    ``x``: ``(B, n_in)`` net input (flow state, time, conditions);
    ``eps``: ``(B, nz)`` probe; ``params``: 3-layer MLP parameter dict with
    ``n_out == nz``.  Returns ``(y (B, nz), e_z (B, nz), div, reg_z, reg_j)``.
    ``compute_dtype``: ``None`` (fp32) or ``torch.bfloat16`` (bf16 operands,
    fp32 accumulation)."""
    if x.device.type == "cpu":
        return mlp3_forward_vjp_reference(x, eps, params, nz, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dynamics_vjp runs on CPU or CUDA tensors, got {x.device}")
    bf16 = _precision(compute_dtype) == "default"
    a1, b1, a2, b2, a3, b3, w1t, w2t, w3t = kernel_operands(params, 0, x, eps)
    b, n_in = x.shape
    h, n_out = a1.shape[0], a3.shape[0]
    if a1.shape[1] != n_in or a2.shape != (h, h) or n_out != nz or eps.shape != (b, nz):
        raise ValueError(
            f"shapes do not fit the kernel: x {tuple(x.shape)}, eps {tuple(eps.shape)}, "
            f"widths {n_in}->{h}->{a2.shape[0]}->{n_out}, nz={nz}"
        )
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden width {h} > {MAX_HIDDEN}: outside the kernel's range")
    x, eps = x.contiguous(), eps.contiguous()
    y = torch.empty((b, nz), dtype=torch.float32, device=x.device)
    ez = torch.empty((b, nz), dtype=torch.float32, device=x.device)
    stats = torch.empty((3, b), dtype=torch.float32, device=x.device)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cnf_fused_dynamics_fwd(
            _ptr(x), _ptr(eps), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(a3), _ptr(b3),
            _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(y), _ptr(ez),
            _ptr(stats[0]), _ptr(stats[1]), _ptr(stats[2]),
            b, n_in, h, n_out, nz, int(bf16), stream,
        )
    _build.check(err, "fused_dynamics_fwd")
    fused_dynamics_vjp.launches += 1
    return y, ez, stats[0], stats[1], stats[2]


# launches of the CUDA kernel since the last reset (a plain counter)
fused_dynamics_vjp.launches = 0
