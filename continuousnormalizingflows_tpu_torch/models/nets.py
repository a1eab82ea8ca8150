"""Dynamics networks (the ``nn`` of an ICNF), as ``torch.nn.Module``s.

Counterpart of ``continuousnormalizingflows_tpu.models.nets``.  A net is an
``nn.Module`` whose parameters live outside the model during a solve, as in
the JAX package: ``init(generator)`` returns a fresh parameter dict and
``apply(params, x)`` runs the module on it through
``torch.func.functional_call``.  The dict keys are the module's own
(``layers.{i}.weight`` of shape ``(out, in)``, ``layers.{i}.bias``);
``utils.convert`` maps it to and from the JAX ``[{"w": (in, out), "b"}]``
layout.

Only ``MLP`` is ported.  ``Planar``, ``CondLayer`` and ``from_flax`` come with
the ROADMAP's Queue 1 item on nets.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device

__all__ = ["DynamicsNet", "MLP", "Params", "linear", "mlp_layers"]

Params = Dict[str, torch.Tensor]


class DynamicsNet(nn.Module):
    """Interface: ``n_in``/``n_out`` widths, ``init(generator, device=None)
    -> params`` (on the card unless ``device`` says otherwise, e.g.
    ``device="cpu"``) and ``apply(params, x) -> y`` over ``(..., n_in) ->
    (..., n_out)``."""

    n_in: int
    n_out: int

    def init(self, generator: torch.Generator, device=None) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self, params, (x,))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: str) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` in ``nn.Linear`` layout ``(out, in)``.

    ``precision="highest"`` is a true float32 product (the caller keeps TF32
    off).  ``"default"`` rounds both operands to bfloat16 and accumulates in
    float32, which is what the CUDA kernels and JAX's bf16 compute dtype do."""
    if precision != "highest":
        x, w = _round_bf16(x), _round_bf16(w)
    y = x @ w.T
    return y if b is None else y + b


def _glorot_uniform(generator: torch.Generator, fan_in: int, fan_out: int,
                    dtype) -> torch.Tensor:
    """Lux's Dense default init (glorot uniform), drawn in ``(out, in)``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_out, fan_in), generator=generator, dtype=dtype,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit


class MLP(DynamicsNet):
    """Softplus MLP ``widths = (n_in, h, ..., n_out)``: softplus on all but the
    last layer, the reference default dynamics net."""

    def __init__(
        self,
        widths: Sequence[int],
        activation: Callable[[torch.Tensor], torch.Tensor] = F.softplus,
        dtype=torch.float32,
        precision: str = "highest",
    ) -> None:
        super().__init__()
        if len(widths) < 2:
            raise ValueError("MLP needs at least an input and an output width")
        if precision not in ("highest", "default"):
            raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
        self.widths = tuple(int(w) for w in widths)
        self.activation = activation
        self.dtype = dtype
        self.precision = precision
        self.n_in = self.widths[0]
        self.n_out = self.widths[-1]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype) for a, b in zip(self.widths[:-1], self.widths[1:])
        )

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Fresh parameters drawn on ``generator``'s device, then moved to
        ``device`` (default: the card), so one seed gives the same
        parameters on every device."""
        device = resolve_device(device)
        params = {}
        for i, (w_in, w_out) in enumerate(zip(self.widths[:-1], self.widths[1:])):
            params[f"layers.{i}.weight"] = _glorot_uniform(generator, w_in, w_out, self.dtype)
            params[f"layers.{i}.bias"] = torch.zeros(w_out, dtype=self.dtype,
                                                     device=generator.device)
        return {k: v.to(device) for k, v in params.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = linear(h, layer.weight, layer.bias, self.precision)
            if i != last:
                h = self.activation(h)
        return h


def mlp_layers(params: Params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(weight (out, in), bias (out,)), ...]`` of an MLP parameter dict."""
    n = len(params) // 2
    return [(params[f"layers.{i}.weight"], params[f"layers.{i}.bias"]) for i in range(n)]
