"""Dynamics networks (the ``nn`` of an ICNF), as ``torch.nn.Module``s.

Counterpart of ``continuousnormalizingflows_tpu.models.nets``.  A net is an
``nn.Module`` whose parameters live outside the model during a solve, as in
the JAX package: ``init(generator)`` returns a fresh parameter dict and
``apply(params, x)`` runs the module on it through
``torch.func.functional_call``.  The dict keys are the module's own
(``layers.{i}.weight`` of shape ``(out, in)``, ``layers.{i}.bias``);
``utils.convert`` maps it to and from the JAX ``[{"w": (in, out), "b"}]``
layout.

``MLP`` (the reference default), ``Planar`` (planar-flow dynamics, params
``u``, ``w``, ``b``, the same layout as JAX's) with ``planar_h``,
``CondLayer`` (appends a constant condition to the input),
``from_torch`` (any ``nn.Module``, in place of JAX's ``from_flax``) and
``ConcatConvNet`` (FFJORD's convolutional dynamics of an image-shaped
state; the port's own, with no JAX counterpart).

``apply_t(params, x)`` is the feature-first apply of ``layout="feature_first"``:
``(..., n_in, batch) -> (..., n_out, batch)``.  ``MLP`` and ``Planar`` run
native transposed chains; any other net runs ``apply`` between transposes.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..parallel import mesh as pmesh

__all__ = ["DynamicsNet", "MLP", "Planar", "CondLayer", "ConcatConvNet", "planar_h", "from_torch",
           "Params", "linear", "linear_t", "mlp_layers"]

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

    def apply_t(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Feature-first apply, ``(..., n_in, batch) -> (..., n_out, batch)``:
        ``apply`` between transposes of the last two axes."""
        return self.apply(params, x.transpose(-2, -1)).transpose(-2, -1)


class ConcatConvNet(DynamicsNet):
    """FFJORD's image dynamics (``ODEnet`` of ``ConcatConv2d`` layers): on a
    state of shape ``(c, h, w)``, every layer is a 3 x 3 convolution (stride
    1, padding 1, with bias) of ``[t, x]``, the input with a constant channel
    ``t`` put in front of it; softplus (``activation``) after all but the
    last.  Widths ``c -> hidden... -> c``.

    A :class:`DynamicsNet` over flattened rows: ``n_in = c*h*w + 1`` (the
    state, then ``t``), ``n_out = c*h*w``.  Params ``layers.{i}.weight``
    ``(out, in + 1, 3, 3)`` (input channel 0 is ``t``) and
    ``layers.{i}.bias``."""

    def __init__(self, shape: Sequence[int], hidden: Sequence[int] = (64, 64, 64),
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.softplus,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != 3:
            raise ValueError(f"ConcatConvNet takes a (c, h, w) shape, got {shape!r}")
        c, h, w = self.shape
        self.hidden = tuple(int(x) for x in hidden)
        self.activation = activation
        self.dtype = dtype
        self.channels = (c,) + self.hidden + (c,)
        self.n_in = c * h * w + 1
        self.n_out = c * h * w
        self.layers = nn.ModuleList(
            nn.Conv2d(a + 1, b, 3, padding=1, dtype=dtype)
            for a, b in zip(self.channels[:-1], self.channels[1:])
        )

    def init(self, generator: torch.Generator, device=None) -> Params:
        """``nn.Conv2d``'s default draws (weights and biases uniform within
        ``1 / sqrt(fan_in)``, ``fan_in = 9 (in + 1)``), layer after layer,
        weight then bias, on ``generator``'s device, then moved to
        ``device`` (default: the card)."""
        device = resolve_device(device)
        params = {}
        for i, (a, b) in enumerate(zip(self.channels[:-1], self.channels[1:])):
            bound = 1.0 / math.sqrt(9 * (a + 1))
            for name, shape in (("weight", (b, a + 1, 3, 3)), ("bias", (b,))):
                u = torch.rand(shape, generator=generator, dtype=self.dtype,
                               device=generator.device)
                params[f"layers.{i}.{name}"] = (2.0 * u - 1.0) * bound
        return {k: v.to(device) for k, v in params.items()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        c, h, w = self.shape
        hcur = x[..., :-1].reshape((-1, c, h, w))
        tt = x[..., -1].reshape(-1, 1, 1, 1).expand(-1, 1, h, w)
        last = len(self.layers) - 1
        for i in range(len(self.layers)):
            hcur = F.conv2d(torch.cat([tt, hcur], dim=1), params[f"layers.{i}.weight"],
                            params[f"layers.{i}.bias"], padding=1)
            if i != last:
                hcur = self.activation(hcur)
        return hcur.reshape(lead + (self.n_out,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(dict(self.named_parameters()), x)

    def apply_t(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            'ConcatConvNet runs batch-first only: layout="feature_first" would put the '
            'batch after the image axes; use the default layout="batch_first"')


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: str) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` in ``nn.Linear`` layout ``(out, in)``.

    ``precision="highest"`` is a true float32 product (the caller keeps TF32
    off).  ``"default"`` rounds both operands to bfloat16 and accumulates in
    float32, which is what the CUDA kernels and JAX's bf16 compute dtype do.
    The transpose is ``w.t()``, not the ``.T`` property: inside a
    ``while_loop`` body (the exported solve) the property on a weight the
    body closes over is lifted as a second input aliasing the first."""
    if precision != "highest":
        x, w = _round_bf16(x), _round_bf16(w)
    y = x @ w.t()
    return y if b is None else y + b


def linear_t(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             precision: str) -> torch.Tensor:
    """The feature-first :func:`linear`: ``w @ x + b[:, None]`` for ``x`` of
    shape ``(..., in, batch)``, with the same operand rounding."""
    if precision != "highest":
        x, w = _round_bf16(x), _round_bf16(w)
    y = w @ x
    return y if b is None else y + b[:, None]


def _glorot_uniform(generator: torch.Generator, fan_in: int, fan_out: int,
                    dtype) -> torch.Tensor:
    """Lux's Dense default init (glorot uniform), drawn in ``(out, in)``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_out, fan_in), generator=generator, dtype=dtype,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit


class MLP(DynamicsNet):
    """Softplus MLP ``widths = (n_in, h, ..., n_out)``: softplus on all but the
    last layer, the reference default dynamics net.

    Tensor-parallel inside a sharded step that splits it
    (:func:`..parallel.mesh.shard_mlp_params`): layer 0 is column-parallel
    (its input passes Megatron's ``f``: identity forward, all-reduce
    backward), layer 1 row-parallel (its product passes ``g``: all-reduce
    forward, identity backward, then its bias once); both are twice
    differentiable, as the probe VJP under ``create_graph`` needs."""

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

    def tp_group(self, params: Params):
        """The ``model`` group where ``params`` are a tensor-parallel rank's
        slices (layer 0 narrower than its width), else None."""
        g = pmesh.tp_group()
        if g is None or params["layers.0.weight"].shape[0] == self.widths[1]:
            return None
        return g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        tp = self.tp_group({"layers.0.weight": self.layers[0].weight})
        for i, layer in enumerate(self.layers):
            if tp is not None and i == 0:
                h = pmesh.copy_to_model(h, tp)
            if tp is not None and i == 1:
                h = pmesh.reduce_from_model(linear(h, layer.weight, None, self.precision),
                                            tp) + layer.bias
            else:
                h = linear(h, layer.weight, layer.bias, self.precision)
            if i != last:
                h = self.activation(h)
        return h

    def apply_t(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The feature-first chain ``W h + b[:, None]`` on the same
        parameters, tensor-parallel as :meth:`forward`."""
        layers = mlp_layers(params)
        tp = self.tp_group(params)
        h, last = x, len(layers) - 1
        for i, (w, b) in enumerate(layers):
            if tp is not None and i == 0:
                h = pmesh.copy_to_model(h, tp)
            if tp is not None and i == 1:
                h = pmesh.reduce_from_model(linear_t(h, w, None, self.precision), tp) + b[:, None]
            else:
                h = linear_t(h, w, b, self.precision)
            if i != last:
                h = self.activation(h)
        return h


def mlp_layers(params: Params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(weight (out, in), bias (out,)), ...]`` of an MLP parameter dict."""
    n = len(params) // 2
    return [(params[f"layers.{i}.weight"], params[f"layers.{i}.bias"]) for i in range(n)]


class Planar(DynamicsNet):
    """Planar-flow dynamics ``u * act(w . x + b)`` (the reference
    ``PlanarLayer``): params ``u`` ``(n_out,)``, ``w`` ``(n_in,)`` and, with
    ``use_bias``, a scalar ``b``, as in the JAX package."""

    def __init__(self, n_in: int, n_out: Optional[int] = None,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 use_bias: bool = True, dtype=torch.float32) -> None:
        super().__init__()
        self.n_in = int(n_in)
        self.n_out = int(n_out) if n_out is not None else int(n_in)
        self.activation = activation
        self.use_bias = use_bias
        self.dtype = dtype
        self.u = nn.Parameter(torch.zeros(self.n_out, dtype=dtype))
        self.w = nn.Parameter(torch.zeros(self.n_in, dtype=dtype))
        self.b = nn.Parameter(torch.zeros((), dtype=dtype)) if use_bias else None

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Glorot-uniform ``u`` (as a ``(1, n_out)`` matrix) and ``w`` (as
        ``(n_in, 1)``), a zero ``b``; drawn on ``generator``'s device, then
        moved to ``device`` (default: the card)."""
        device = resolve_device(device)
        params = {"u": _glorot_uniform(generator, 1, self.n_out, self.dtype)[:, 0],
                  "w": _glorot_uniform(generator, self.n_in, 1, self.dtype)[0]}
        if self.use_bias:
            params["b"] = torch.zeros((), dtype=self.dtype, device=generator.device)
        return {k: v.to(device) for k, v in params.items()}

    def _pre(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``w . x + b`` over the last axis, in full float32."""
        h = x @ params["w"]
        return h + params["b"] if self.use_bias else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {"w": self.w, "b": self.b}
        return self.activation(self._pre(params, x))[..., None] * self.u

    def _pre_t(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``w . x + b`` over the feature axis of ``(..., n_in, batch)``."""
        h = params["w"] @ x
        return h + params["b"] if self.use_bias else h

    def apply_t(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return params["u"][:, None] * self.activation(self._pre_t(params, x))[..., None, :]


def planar_h(net: Planar, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The scalar activation before ``u``, ``act(w . x + b)`` (the reference's
    ``pl_h``)."""
    return net.activation(net._pre(params, x))


class CondLayer(DynamicsNet):
    """A net whose input gets a constant condition ``ys`` appended (the
    reference ``CondLayer``): the wrapped net sees ``[x, ys]``; a scalar
    ``ys`` is one column.  Its params are the wrapped net's."""

    def __init__(self, net: DynamicsNet, ys) -> None:
        super().__init__()
        ys = torch.as_tensor(ys)
        if ys.ndim == 0:
            ys = ys.reshape(1, 1)
        elif ys.ndim == 1:
            ys = ys[None, :]
        self.net = net
        self.ys = ys
        self.n_in = net.n_in - ys.shape[-1]
        self.n_out = net.n_out
        if self.n_in <= 0:
            raise ValueError("conditioning width must be smaller than net input")

    def init(self, generator: torch.Generator, device=None) -> Params:
        return self.net.init(generator, device)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        ys = self.ys.to(device=x.device, dtype=x.dtype)
        return self.net.apply(params, torch.cat(
            [x, ys.expand(x.shape[:-1] + (ys.shape[-1],))], dim=-1))


class _TorchNet(DynamicsNet):
    def __init__(self, module: nn.Module, n_in: int, n_out: int) -> None:
        super().__init__()
        self.module = module
        self.n_in = int(n_in)
        self.n_out = int(n_out)

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Fresh parameters in the module's own initialization: a copy of the
        module on the CPU gets ``reset_parameters()`` on every submodule that
        has one, with the CPU's global RNG seeded from one draw of
        ``generator`` and restored afterwards; parameters of submodules
        without ``reset_parameters`` keep the module's values.  The module
        itself is not changed; the parameters go to ``device`` (default: the
        card)."""
        device = resolve_device(device)
        seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
        fresh = copy.deepcopy(self.module).to("cpu")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            for m in fresh.modules():
                if callable(getattr(m, "reset_parameters", None)):
                    m.reset_parameters()
        return {k: v.detach().to(device) for k, v in fresh.named_parameters()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.module, params, (x,))


def from_torch(module: nn.Module, n_in: int, n_out: int) -> DynamicsNet:
    """Wrap an ``nn.Module`` (``forward(x: (..., n_in)) -> (..., n_out)``) as
    a dynamics net, as the reference takes any Lux layer (JAX:
    ``from_flax``).  ``apply`` runs the module on the given parameters through
    ``torch.func.functional_call``."""
    return _TorchNet(module, n_in, n_out)
