"""Augmented ODE dynamics.

Counterpart of ``continuousnormalizingflows_tpu.ops.dynamics``.  State per
row ``u = [z (nz), dlogp, E, n]``; the derivative is
``du = [dz, -tr(J) estimate, |dz|, |eps^T J|]``, with the two regularizer
columns zero unless the mode and the lambdas ask for them.

With ``layout="feature_first"`` the same dynamics take the transposed state
``(state_dim, batch)``, probes ``(P, nz, batch)`` and conditions
``(nconditions, batch)`` (JAX's ``_make_augmented_dynamics_t``): the nets'
``apply_t``, every branch below but the fused stage, the sums and norms
over the feature axis; ``core._solve`` transposes once in and once out.

The branches, in the JAX package's order: the fused Hutchinson-VJP stage
(K1, :mod:`.fused_dynamics`); the planar net's analytic trace (with its
exact Frobenius ``reg_j``); the analytic trace of 1- and 2-hidden-layer
MLPs; the generic exact sweep (one JVP a basis row, in blocks of
``exact_chunk`` rows when it is set); the Hutchinson VJP
(``torch.autograd.grad``; a :class:`ConcatConvNet`'s written out,
:func:`_conv_probe_vjps`) and the Hutchinson JVP.  The JVPs of the port's
own nets (an MLP of any depth or a planar net, under any ``CondLayer``s,
with an activation of :data:`ACTIVATION_DERIVATIVES`) are written out: the
tangents pushed through each product and each activation's derivative
(:func:`_written_jvps`), the same code eager, under autograd and under
``torch.export``.  Any other net's (``from_torch``) run in forward mode
(``torch.autograd.forward_ad``), except in the device loop of the exported
surfaces, where a ``from_torch`` net's graph (``torch.fx``) is run with a
tangent carried through each node (:func:`_fx_jvps`).  Both stay
differentiable by autograd, also under the non-reentrant checkpoint of
``remat``.

Inside a sharded step (:func:`..parallel.mesh.use_mesh`): with
``probe_axis`` each ``model`` rank holds its share of the probes and the
ensemble mean is a sum over the ranks (a differentiable all-reduce); with
``sweep_axis`` each sweeps its block of basis rows and the trace is summed
likewise; a tensor-parallel MLP's hidden width is split, so its analytic
trace all-reduces its contraction over that width (the Hutchinson VJP gets
this from the net's own collectives), and the fused stage gathers the
slices into the whole net first.  Where the model ranks split the probes or
the sweep of a tensor-parallel MLP, each runs its share through the whole
net, gathered, and the net's cotangents are averaged over the ranks
(:func:`..parallel.mesh.whole_mlp_params` with ``shares=True``).
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Optional

import torch
import torch.autograd.forward_ad as fwad
import torch.nn.functional as F
from torch import nn

from ..config import ICNFConfig, Mode, TraceEstimator
from ..models.nets import (MLP, ConcatConvNet, CondLayer, DynamicsNet, Params, Planar, _TorchNet,
                           linear, linear_t, mlp_layers)
from ..parallel import mesh as pmesh
from .fused_dynamics import MAX_HIDDEN, _row_norm, fused_dynamics_vjp

__all__ = ["make_augmented_dynamics", "make_field", "make_field_t", "fused_dynamics_applicable",
           "exact_trace_traceable", "ACTIVATION_DERIVATIVES"]

Args = dict


def _net_input(cfg: ICNFConfig, t, z: torch.Tensor, ys: Optional[torch.Tensor],
               ff: bool = False) -> torch.Tensor:
    """``[z, t (non-autonomous), ys (conditioned)]`` along the last axis; with
    ``ff`` (feature-first: ``z`` ``(..., nz, batch)``, ``ys`` ``(nconditions,
    batch or 1)``) along the axis before it."""
    if ff:
        rows = [z]
        if not cfg.autonomous:
            tt = torch.as_tensor(t, dtype=z.dtype, device=z.device)
            rows.append(tt.expand(z.shape[:-2] + (1, z.shape[-1])))
        if cfg.conditioned:
            if ys is None:
                raise ValueError("conditioned ICNF requires ys")
            rows.append(ys.to(z.dtype).expand(z.shape[:-2] + (ys.shape[0], z.shape[-1])))
        return torch.cat(rows, dim=-2)
    cols = [z]
    if not cfg.autonomous:
        tt = torch.as_tensor(t, dtype=z.dtype, device=z.device)
        cols.append(tt.expand(z.shape[:-1] + (1,)))
    if cfg.conditioned:
        if ys is None:
            raise ValueError("conditioned ICNF requires ys")
        cols.append(ys.to(z.dtype).expand(z.shape[:-1] + (ys.shape[-1],)))
    return torch.cat(cols, dim=-1)


def make_field(cfg: ICNFConfig, net: DynamicsNet) -> Callable:
    """The raw vector field ``f(t, z, params, ys) -> dz``, ``(B, nz) -> (B, nz)``."""

    def field(t, z: torch.Tensor, params: Params, ys: Optional[torch.Tensor]) -> torch.Tensor:
        return net.apply(params, _net_input(cfg, t, z, ys))

    return field


def make_field_t(cfg: ICNFConfig, net: DynamicsNet) -> Callable:
    """Feature-first :func:`make_field`: ``(nz, B) -> (nz, B)``, conditions
    ``(nconditions, B)``, through the net's ``apply_t``."""

    def field(t, z: torch.Tensor, params: Params, ys: Optional[torch.Tensor]) -> torch.Tensor:
        return net.apply_t(params, _net_input(cfg, t, z, ys, ff=True))

    return field


def _col_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-column Euclidean norm (over the feature axis of a feature-first
    array), floored at 1e-20 under the root as :func:`_row_norm`."""
    return torch.sqrt(torch.sum(torch.square(x), dim=-2) + 1e-20)


def probe_share(cfg: ICNFConfig):
    """``(start, stop, group)``: this rank's share of the probe ensemble under
    ``probe_axis`` (with more than one probe, as in JAX), ``group`` the one
    its sum is all-reduced over; ``(0, nprobes, None)`` unsplit."""
    axis = cfg.probe_axis if cfg.nprobes > 1 else None
    lo, hi, group = pmesh.model_share(axis, cfg.nprobes)
    if group is not None and cfg.nprobes % pmesh.active().model_size:
        raise ValueError(f"nprobes={cfg.nprobes} does not split over the "
                         f"{pmesh.active().model_size} ranks of the {cfg.probe_axis!r} axis")
    return lo, hi, group


def _probe_mean(x: torch.Tensor, nprobes: int, group) -> torch.Tensor:
    """The ensemble mean over the leading probe axis of ``x``: local, or the
    sum of every model rank's share over ``nprobes``."""
    if group is None:
        return torch.mean(x, dim=0)
    return pmesh.sum_over_model(torch.sum(x, dim=0), group) / nprobes


def _mlp_exact_applicable(net) -> bool:
    return isinstance(net, MLP) and len(net.widths) in (3, 4)


def _softplus(z):
    return F.softplus(z), torch.sigmoid(z)


def _tanh(z):  # autograd's tanh_backward, 1 - a^2
    a = torch.tanh(z)
    return a, 1 - a * a


def _sigmoid(z):
    s = torch.sigmoid(z)
    return s, s * (1 - s)


def _relu(z):
    return torch.relu(z), (z > 0).to(z.dtype)


def _elu(z):  # alpha = 1
    return F.elu(z), torch.where(z > 0, torch.ones_like(z), torch.exp(z))


def _gelu(z):  # the exact (erf) form, F.gelu's default
    phi = torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))
    return F.gelu(z), 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0)))) + z * phi


def _silu(z):
    s = torch.sigmoid(z)
    return F.silu(z), s * (1 + z * (1 - s))


# the activations whose derivative is written out: ``act -> z -> (act(z),
# act'(z))``, plain tensor operations that ``torch.export`` captures and
# autograd differentiates again
ACTIVATION_DERIVATIVES = {
    F.softplus: _softplus, torch.tanh: _tanh, F.tanh: _tanh,
    torch.sigmoid: _sigmoid, F.sigmoid: _sigmoid, torch.relu: _relu, F.relu: _relu,
    F.elu: _elu, F.gelu: _gelu, F.silu: _silu,
}


def _act_and_deriv(act, z: torch.Tensor):
    """``(act(z), act'(z))`` of an elementwise activation: written out for
    those of :data:`ACTIVATION_DERIVATIVES`, else from autograd
    (``create_graph`` where ``z`` is in a graph, so it stays differentiable,
    also under a non-reentrant checkpoint; not captured by ``torch.export``)."""
    written = ACTIVATION_DERIVATIVES.get(act)
    if written is not None:
        return written(z)
    train = torch.is_grad_enabled() and z.requires_grad
    with torch.enable_grad():
        zz = z if train else z.detach().requires_grad_()
        a = act(zz)
        (d,) = torch.autograd.grad(a.sum(), zz, create_graph=train)
    return (a, d) if train else (a.detach(), d.detach())


def _written_net(net, fx: bool = False):
    """``(inner, conditions)`` where the JVPs of ``net`` are written out: an
    MLP or a planar net with an activation of
    :data:`ACTIVATION_DERIVATIVES`, and with ``fx`` a ``from_torch`` net
    whose graph :func:`fx_refusal` accepts, under any ``CondLayer``s (whose
    conditions, outermost first, are appended to its input); else None."""
    conds = []
    while isinstance(net, CondLayer):
        conds.append(net.ys)
        net = net.net
    if isinstance(net, (MLP, Planar)) and net.activation in ACTIVATION_DERIVATIVES:
        return net, conds
    if fx and isinstance(net, _TorchNet) and fx_refusal(net) is None:
        return net, conds
    return None


def exact_trace_traceable(net) -> bool:
    """Whether the exact trace of ``net`` traces for ``torch.export``: the
    analytic planar and MLP traces and the written-out sweep
    (:func:`_written_net`), a ``from_torch`` net's through its ``torch.fx``
    graph (:func:`_fx_jvps`)."""
    return _written_net(net, fx=True) is not None


def activation_name(net) -> Optional[str]:
    """The name of the activation of ``net`` (under its ``CondLayer``s) that
    has no written-out derivative, or None."""
    while isinstance(net, CondLayer):
        net = net.net
    act = getattr(net, "activation", None)
    if act is None or act in ACTIVATION_DERIVATIVES:
        return None
    return getattr(act, "__name__", repr(act))


def _written_jvps(net, conds, params: Params, x_full: torch.Tensor, nz: int,
                  tangents: torch.Tensor, ff: bool = False):
    """``(field, J tangents)`` of a :func:`_written_net` at ``x_full`` (the
    field's input, before the ``CondLayer`` conditions), for tangents ``(C,
    B or 1, nz)`` on the ``z`` columns (zero on the time and condition
    columns): forward mode written out, the tangents through each product
    (without its bias) and times each activation's derivative.  A
    tensor-parallel MLP sums its row-parallel product's tangent over the
    model ranks as it sums the product.  ``ff``: feature-first, ``x_full``
    ``(n_in, B)`` and tangents ``(C, nz, B or 1)``, through the transposed
    chains (a ``from_torch`` net's graph between transposes)."""
    for ys in conds:
        ys = ys.to(device=x_full.device, dtype=x_full.dtype)
        if ff:
            x_full = torch.cat(
                [x_full, ys.t().expand(x_full.shape[:-2] + (ys.shape[-1], x_full.shape[-1]))],
                dim=-2)
        else:
            x_full = torch.cat([x_full, ys.expand(x_full.shape[:-1] + (ys.shape[-1],))], dim=-1)
    if isinstance(net, _TorchNet):
        if not ff:
            return _fx_jvps(net, params, x_full, nz, tangents)
        dz, tan = _fx_jvps(net, params, x_full.transpose(-2, -1), nz,
                           tangents.transpose(-2, -1))
        return dz.transpose(-2, -1), tan.transpose(-2, -1)
    if isinstance(net, Planar):
        u, w = params["u"], params["w"]
        if ff:
            a, d = _act_and_deriv(net.activation, net._pre_t(params, x_full))
            return u[:, None] * a[..., None, :], (d * (w[:nz] @ tangents))[..., None, :] * u[:, None]
        a, d = _act_and_deriv(net.activation, net._pre(params, x_full))
        return a[..., None] * u, (d * (tangents @ w[:nz]))[..., None] * u
    prec = net.precision
    lin, col = (linear_t, lambda b: b[:, None]) if ff else (linear, lambda b: b)
    layers = mlp_layers(params)
    tp = net.tp_group(params)
    if tp is not None:
        x_full = pmesh.copy_to_model(x_full, tp)
    h, last = x_full, len(layers) - 1
    for i, (a, b) in enumerate(layers):
        if i == 0:
            h, tan = lin(h, a, b, prec), lin(tangents, a[:, :nz], None, prec)
        elif i == 1 and tp is not None:
            h = pmesh.reduce_from_model(lin(h, a, None, prec), tp) + col(b)
            tan = pmesh.reduce_from_model(lin(tan, a, None, prec), tp)
        else:
            h, tan = lin(h, a, b, prec), lin(tan, a, None, prec)
        if i != last:
            h, d = _act_and_deriv(net.activation, h)
            tan = d * tan
    return h, tan.expand(tangents.shape[:1] + h.shape)


# ---- the forward mode of a from_torch net's graph, written out ----

# activation modules whose derivative is written out: type -> (the function
# of ACTIVATION_DERIVATIVES, whether the module's settings are that function's)
_FX_ACT_MODULES = {
    nn.Softplus: (F.softplus, lambda m: m.beta == 1 and m.threshold == 20),
    nn.Tanh: (torch.tanh, lambda m: True), nn.Sigmoid: (torch.sigmoid, lambda m: True),
    nn.ReLU: (torch.relu, lambda m: True), nn.ELU: (F.elu, lambda m: m.alpha == 1.0),
    nn.GELU: (F.gelu, lambda m: m.approximate == "none"), nn.SiLU: (F.silu, lambda m: True),
}
_FX_KIND = {operator.add: "add", torch.add: "add", operator.sub: "sub", torch.sub: "sub",
            operator.mul: "mul", torch.mul: "mul", operator.neg: "neg", torch.neg: "neg",
            torch.cat: "cat", torch.stack: "cat", operator.getitem: "getitem",
            torch.reshape: "reshape"}
# nodes whose value is no tensor (a shape, a size): they carry no tangent
_FX_SHAPE_ATTRS = ("shape",)
_FX_SHAPE_METHODS = ("size",)


class _Ref:
    """The value of an earlier step of a compiled graph, by its index."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _method(name: str):
    return lambda x, *a, **k: getattr(x, name)(*a, **k)


def _resolve(a, vals):
    """``a`` (a node's arguments) with each :class:`_Ref` replaced by its value."""
    if isinstance(a, _Ref):
        return vals[a.i]
    if isinstance(a, tuple):
        return tuple(_resolve(v, vals) for v in a)
    if isinstance(a, list):
        return [_resolve(v, vals) for v in a]
    if isinstance(a, slice):
        return slice(_resolve(a.start, vals), _resolve(a.stop, vals), _resolve(a.step, vals))
    if isinstance(a, dict):
        return {k: _resolve(v, vals) for k, v in a.items()}
    return a


def _fx_name(node) -> str:
    if node.op == "call_function":
        return f"call_function {torch.fx.node._get_qualified_name(node.target)}"
    return f"{node.op} {node.target}"


def _fx_step(gm, node, live):
    """``(kind, fn, args, kwargs)`` of ``node`` (args with :class:`_Ref`\\ s
    for nodes; ``live(a)``: whether a tangent reaches ``a``), or the refusal
    (a string naming the node) where a tangent reaches it and no rule of
    :func:`_fx_jvps` carries it."""
    to_ref = lambda a: torch.fx.node.map_arg(a, lambda n: _Ref(n.meta["_fx_index"]))
    args, kwargs = to_ref(tuple(node.args)), to_ref(dict(node.kwargs))
    name, op, f = _fx_name(node), node.op, node.target
    carried = any(live(a) for a in node.all_input_nodes)
    first_only = bool(node.args) and live(node.args[0]) and not any(
        live(a) for a in node.all_input_nodes if a is not node.args[0])
    if (op == "call_function" and f is getattr and node.args[1] in _FX_SHAPE_ATTRS) or (
            op == "call_method" and f in _FX_SHAPE_METHODS):
        return ("call", f if op == "call_function" else _method(f), args, kwargs)
    if op == "call_module":
        m = gm.get_submodule(node.target)
        one = len(node.args) == 1 and not node.kwargs
        if isinstance(m, nn.Linear) and one:
            return ("linear", (f"{f}.weight", None if m.bias is None else f"{f}.bias"), args, {})
        act = _FX_ACT_MODULES.get(type(m))
        if act is not None and one:
            if not act[1](m):
                return (f"{name} ({type(m).__name__} with other settings than "
                        f"F.{act[0].__name__}'s defaults)")
            return ("act", act[0], args, {})
        return f"{name} ({type(m).__name__})"
    fn = _method(f) if op == "call_method" else f
    if not carried:
        return ("call", fn, args, kwargs)
    if op == "call_method":
        return ("reshape", fn, args, kwargs) if f in ("reshape", "view") and first_only else name
    if f is F.linear and first_only:
        return ("flinear", f, args, kwargs)
    if f in ACTIVATION_DERIVATIVES and len(node.args) == 1 and not node.kwargs:
        return ("act", f, args, {})
    kind = _FX_KIND.get(f)
    if kind in ("add", "sub", "neg") and not node.kwargs:
        return (kind, f, args, kwargs)
    if kind == "mul" and not node.kwargs and sum(live(a) for a in node.args) == 1:
        return (kind, f, args, kwargs)
    if kind == "cat" and isinstance(node.args[0], (list, tuple)) and not any(
            live(a) for a in node.args[1:]) and not any(live(v) for v in node.kwargs.values()):
        return (kind, f, args, kwargs)
    if kind in ("getitem", "reshape") and first_only:
        return (kind, f, args, kwargs)
    return name


def fx_refusal(net: _TorchNet) -> Optional[str]:
    """None where :func:`_fx_jvps` runs the forward mode of ``net``'s module:
    ``torch.fx`` traces it, its forward takes one input, its submodules are
    ``nn.Linear`` and the activations below, and every node that a tangent
    reaches is ``nn.Linear`` or ``F.linear`` (on a tangent-free weight), an
    activation of :data:`ACTIVATION_DERIVATIVES` (a module or a function),
    ``+`` or ``-``, ``*`` by a
    constant or a tangent-free tensor, a negation, ``torch.cat``,
    ``torch.stack``, indexing or slicing, or ``reshape``/``view``; else what
    refuses, naming the node.  The compiled graph, plain Python data, is
    kept on the net."""
    plan = net.__dict__.get("_fx_plan")
    if plan is not None:
        return plan[1]
    try:
        gm = torch.fx.symbolic_trace(net.module)
    except Exception as err:  # what fx raises is its own or the module's
        plan = (None, f"torch.fx cannot trace the module ({type(err).__name__}: {err})")
    else:
        steps, carries, why = [], set(), None
        live = lambda a: isinstance(a, torch.fx.Node) and a in carries
        for i, node in enumerate(gm.graph.nodes):
            node.meta["_fx_index"] = i
            if node.op == "placeholder":
                if carries:
                    why = f"a forward with more than one input ({node.target})"
                    break
                carries.add(node)
                steps.append(("input", None, (), {}))
            elif node.op == "get_attr":
                steps.append(("param", node.target, (), {}))
            elif node.op == "output":
                steps.append(("output", None, (_Ref(node.args[0].meta["_fx_index"]),), {}))
            else:
                step = _fx_step(gm, node, live)
                if isinstance(step, str):
                    why = step
                    break
                if step[0] != "call" and any(live(a) for a in node.all_input_nodes):
                    carries.add(node)
                steps.append(step)
        plan = (None if why else tuple(steps), why)
    object.__setattr__(net, "_fx_plan", plan)  # plain data, not a submodule
    return plan[1]


def _fx_param(module: nn.Module, params: Params, name: str):
    """A parameter by its qualified name: from ``params``, else (a buffer,
    a constant) the module's own."""
    if name in params:
        return params[name]
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _lift(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A tangent ``(C, ...)`` with singleton axes after ``C`` up to ``ndim``."""
    if t.ndim == ndim:
        return t
    return t.reshape(t.shape[:1] + (1,) * (ndim - t.ndim) + t.shape[1:])


def _fx_full(t: Optional[torch.Tensor], v: torch.Tensor, c: int) -> torch.Tensor:
    """The tangent of ``v`` at its full shape ``(C, *v.shape)`` (zeros for None)."""
    if t is None:
        return v.new_zeros((c,) + v.shape)
    return _lift(t, v.ndim + 1).expand((c,) + v.shape)


def _fx_jvps(net: _TorchNet, params: Params, x_full: torch.Tensor, nz: int,
             tangents: torch.Tensor):
    """``(field, J tangents)`` of a ``from_torch`` net at ``x_full`` ``(B,
    n_in)`` for tangents ``(C, B or 1, nz)`` on the ``z`` columns: its
    ``torch.fx`` graph, compiled by :func:`fx_refusal` into steps, run step
    by step, each value with its tangent ``(C, ...)`` (one axis more than
    the value, broadcast against it; None where no tangent reaches): through
    a linear product without its bias, times an activation's written
    derivative, summed under ``+``/``-``, scaled under ``*``, and cut,
    joined and reshaped as the value is.  Plain tensor operations in a
    Python loop over plain data: the same code eager, under autograd and
    under ``torch.export``."""
    why = fx_refusal(net)
    if why is not None:
        raise NotImplementedError(f"the forward mode of this from_torch net is not written "
                                  f"out: {why}")
    c = tangents.shape[0]
    vals, tans = [], []
    tan_of = lambda a: tans[a.i] if isinstance(a, _Ref) else None
    for kind, fn, args, kwargs in net.__dict__["_fx_plan"][0]:
        t = None
        if kind == "input":
            pad = tangents.new_zeros(tangents.shape[:-1] + (x_full.shape[-1] - nz,))
            v, t = x_full, torch.cat([tangents, pad], dim=-1)
        elif kind == "param":
            v = _fx_param(net.module, params, fn)
        elif kind == "output":
            v = vals[args[0].i]
            return v, _fx_full(tans[args[0].i], v, c)
        else:
            a, k = _resolve(args, vals), _resolve(kwargs, vals)
            t0 = tan_of(args[0]) if args else None
            if kind == "linear":
                w = _fx_param(net.module, params, fn[0])
                v = F.linear(a[0], w, None if fn[1] is None else _fx_param(net.module, params,
                                                                           fn[1]))
                t = None if t0 is None else F.linear(t0, w)
            elif kind == "act":
                if t0 is None:
                    v = fn(a[0])
                else:
                    v, d = ACTIVATION_DERIVATIVES[fn](a[0])
                    t = d * _lift(t0, d.ndim + 1)
            else:
                v = fn(*a, **k)
                t = _fx_tangent(kind, v, a, k, args, tan_of, t0, c)
        vals.append(v)
        tans.append(t)
    raise AssertionError("a torch.fx graph ends in its output node")


def _fx_tangent(kind, v, a, k, args, tan_of, t0, c):
    """The tangent of a step's value ``v`` (None where none reaches it)."""
    if kind == "call":
        return None
    if kind == "flinear":
        return F.linear(t0, a[1] if len(a) > 1 else k["weight"])
    if kind in ("add", "sub"):
        ta, tb = (None if t is None else _lift(t, v.ndim + 1)
                  for t in (t0, tan_of(args[1])))
        if tb is None:
            return ta
        tb = -tb if kind == "sub" else tb
        return tb if ta is None else ta + tb
    if kind == "mul":
        i = 0 if t0 is not None else 1
        return _lift(tan_of(args[i]), v.ndim + 1) * a[1 - i]
    if kind == "neg":
        return -t0
    if kind == "cat":
        dim = a[1] if len(a) > 1 else k.get("dim", 0)
        return (torch.cat if v.ndim == a[0][0].ndim else torch.stack)(
            [_fx_full(tan_of(r), p, c) for r, p in zip(args[0], a[0])], dim=dim % v.ndim + 1)
    if kind == "getitem":
        idx = a[1] if isinstance(a[1], tuple) else (a[1],)
        return _fx_full(t0, a[0], c)[(slice(None),) + idx]
    return _fx_full(t0, a[0], c).reshape((c,) + v.shape)  # reshape / view


def _planar_trace(net: Planar, params: Params, x_full: torch.Tensor, nz: int, reg: bool,
                  ff: bool = False):
    """Analytic ``(dz, tr(J_z), ||J_z||_F)`` of planar dynamics
    ``u * act(w . x + b)``: ``J_z = act' u[:nz] w[:nz]^T`` has rank one, so
    ``tr = (u[:nz] . w[:nz]) act'`` and ``||J_z||_F = |act'| ||u[:nz]||
    ||w[:nz]||`` (None unless ``reg``).  ``ff``: feature-first."""
    pre = net._pre_t(params, x_full) if ff else net._pre(params, x_full)
    a, d = _act_and_deriv(net.activation, pre)
    u, w = params["u"], params["w"]
    dz = u[:, None] * a[..., None, :] if ff else a[..., None] * u
    div = torch.sum(u[:nz] * w[:nz]) * d
    fro = torch.abs(d) * torch.linalg.norm(u[:nz]) * torch.linalg.norm(w[:nz]) if reg else None
    return dz, div, fro


def _jvps(fn, z: torch.Tensor, tangents: torch.Tensor):
    """``(fn(z), J tangents)`` for a stack of tangents ``(C, B or 1, nz)``:
    one forward-mode pass over ``C`` copies of the batch (the net maps any
    leading axes).  Differentiable where ``z`` or what ``fn`` closes over
    requires grad; plain values otherwise.  Forward mode is switched on
    explicitly: an ``autograd.Function``'s forward (the adjoints' forward
    solve) runs with it off."""
    shape = tangents.shape[:1] + z.shape
    with fwad._set_fwd_grad_enabled(True), fwad.dual_level():
        zd = fwad.make_dual(z.expand(shape).contiguous(), tangents.expand(shape).contiguous())
        out = fwad.unpack_dual(fn(zd))
    return out.primal[0], out.tangent


class _Sweep:
    """The axes of a sweep in one layout: the tangents of basis rows ``(C,
    nz)``, the einsums of the diagonal and the axes of ``sum J^2``."""

    def __init__(self, ff: bool):
        self.ff = ff
        self.diag, self.rows, self.sq = (("iib->b", "cjb,cj->b", (0, 1)) if ff
                                         else ("ibi->b", "cbj,cj->b", (0, 2)))

    def tangents(self, basis: torch.Tensor) -> torch.Tensor:
        return basis[:, :, None] if self.ff else basis[:, None, :]

    def batch(self, z: torch.Tensor):
        return z.shape[1:] if self.ff else z.shape[:-1]


def _exact_sweep(jvps, z: torch.Tensor, nz: int, chunk: int, reg: bool, axis=None,
                 ff: bool = False):
    """``(dz, tr(J), sum J^2 or None)`` by JVPs along the basis rows
    (``jvps(tangents (C, 1, nz)) -> (dz, J tangents)``): all ``nz`` at once
    when ``chunk == 0``, else in blocks of ``chunk`` rows (peak memory
    ``(chunk, B, nz)``), the last block's overrun rows zero.  ``axis``
    (``sweep_axis``): inside a sharded step this rank sweeps its block of the
    rows, and the sums are all-reduced over the axis.  ``ff``: feature-first
    (``z`` ``(nz, B)``, tangents ``(C, nz, 1)``)."""
    sw = _Sweep(ff)
    eye = torch.eye(nz, dtype=z.dtype, device=z.device)
    lo, hi, group = pmesh.model_share(axis, nz)
    if group is not None:
        return _shared_sweep(jvps, z, eye[lo:hi], chunk, reg, group, sw)
    if chunk == 0:
        dz, jcols = jvps(sw.tangents(eye))
        div = torch.einsum(sw.diag, jcols)
        return dz, div, torch.sum(torch.square(jcols), dim=sw.sq) if reg else None
    chunk = min(chunk, nz)
    nblocks = -(-nz // chunk)
    basis_all = torch.cat([eye, eye.new_zeros((nblocks * chunk - nz, nz))])
    div = fro = torch.zeros(sw.batch(z), dtype=z.dtype, device=z.device)
    for o in range(0, nblocks * chunk, chunk):
        basis = basis_all[o:o + chunk]
        dz, jrows = jvps(sw.tangents(basis))
        div = div + torch.einsum(sw.rows, jrows, basis)
        if reg:
            fro = fro + torch.sum(torch.square(jrows), dim=sw.sq)
    return dz, div, fro if reg else None


def _shared_sweep(jvps, z: torch.Tensor, rows: torch.Tensor, chunk: int, reg: bool, group,
                  sw: _Sweep):
    """:func:`_exact_sweep` over this rank's ``rows`` of the basis (blocks of
    ``chunk`` of them, all at once when 0), its sums all-reduced in one
    differentiable collective."""
    div = fro = torch.zeros(sw.batch(z), dtype=z.dtype, device=z.device)
    dz = None
    step = chunk if chunk > 0 else max(rows.shape[0], 1)
    for o in range(0, rows.shape[0], step):
        basis = rows[o:o + step]
        dz, jrows = jvps(sw.tangents(basis))
        div = div + torch.einsum(sw.rows, jrows, basis)
        if reg:
            fro = fro + torch.sum(torch.square(jrows), dim=sw.sq)
    if dz is None:  # a rank past the last row: the field alone
        dz = jvps(sw.tangents(rows.new_zeros((1, rows.shape[1]))))[0]
    div, fro = pmesh.sum_over_model(torch.stack([div, fro]), group)
    return dz, div, fro if reg else None


def _mlp_exact_trace(net: MLP, params: Params, x_full: torch.Tensor, nz: int,
                     ff: bool = False):
    """Analytic ``(dz, tr(J_z))`` for 1- and 2-hidden-layer MLPs.

    The z-block Jacobian of ``y = A3 sp(A2 sp(A1 x))`` is
    ``A3[:nz] D2 A2 D1 A1[:, :nz]`` with ``D_i = diag(s_i)``, so
    ``tr(J) = sum_{k,l} s1[k] G[k,l] s2[l]`` with
    ``G = A2^T o (A1[:, :nz] A3[:nz])``: one batch-independent masked
    product and one extra ``(B, h) x (h, h)`` product per evaluation.  The
    transposes are ``.t()`` calls, as in :func:`.models.nets.linear`.
    Tensor-parallel (this rank's slice of the first hidden width): layer 1's
    product and the trace's contraction over that width are all-reduced over
    ``model``.  ``ff``: feature-first, the same products as transposed chains
    (:func:`.models.nets.linear_t`)."""
    prec = net.precision
    lin, col = (linear_t, lambda b: b[:, None]) if ff else (linear, lambda b: b)
    layers = mlp_layers(params)
    tp = net.tp_group(params)
    if tp is not None:
        x_full = pmesh.copy_to_model(x_full, tp)
    # a row-parallel product: summed over the model ranks' slices, then the bias once
    row_par = lambda h, a, b: (lin(h, a, b, prec) if tp is None
                               else pmesh.reduce_from_model(lin(h, a, None, prec), tp) + col(b))
    summed = lambda v: v if tp is None else pmesh.reduce_from_model(v, tp)
    if len(layers) == 2:
        (a1, b1), (a2, b2) = layers
        h1, s1 = _act_and_deriv(net.activation, lin(x_full, a1, b1, prec))
        dz = row_par(h1, a2, b2)
        g = torch.sum(a1[:, :nz] * a2[:nz, :].t(), dim=1)  # (h,)
        return dz, summed(g @ s1 if ff else s1 @ g)
    (a1, b1), (a2, b2), (a3, b3) = layers
    h1, s1 = _act_and_deriv(net.activation, lin(x_full, a1, b1, prec))
    h2, s2 = _act_and_deriv(net.activation, row_par(h1, a2, b2))
    dz = lin(h2, a3, b3, prec)
    m = linear(a1[:, :nz], a3[:nz, :].t(), None, prec)  # (h1, h2)
    g_mat = a2.t() * m
    div = torch.sum(lin(s1, g_mat.t(), None, prec) * s2, dim=-2 if ff else -1)
    return dz, summed(div)


def _probe_vjps(fn, z: torch.Tensor, eps: torch.Tensor, inputs):
    """``(fn(z), stack of eps[p]^T dfn/dz)``.  Built on ``torch.autograd.grad``
    (not ``torch.func.vjp``, which refuses the saved-tensor hooks of a
    non-reentrant checkpoint, i.e. ``remat``).  The results stay in the graph
    when grad is enabled and ``z`` or one of ``inputs`` (what ``fn`` closes
    over) requires grad, and are plain values otherwise."""
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (z, eps, *inputs))
    with torch.enable_grad():
        # outside a recorded graph (e.g. an adjoint's forward under no_grad)
        # z may be a no-grad view of a leaf: differentiate a detached copy
        zz = z if train and z.requires_grad else z.detach().requires_grad_()
        dz = fn(zz)
        eps_j = torch.stack([
            torch.autograd.grad(dz, zz, e, create_graph=train, retain_graph=True)[0]
            for e in eps
        ])  # (P, B, nz)
    return (dz, eps_j) if train else (dz.detach(), eps_j.detach())


def _conv_probe_vjps(net: ConcatConvNet, params: Params, x_full: torch.Tensor,
                     eps: torch.Tensor):
    """``(f, stack of eps[p]^T df/dz)`` of a :class:`ConcatConvNet` at rows
    ``x_full = [z, t]``, the probe VJP written out: through each layer
    backward, the activation's written slope, then the layer's data
    gradient as ``conv_transpose2d`` by its weight less the ``t`` channel.
    Plain operations: with no grad (the adjoint's forward solve) they record
    no graph, and a VJP of them (the adjoint's backward) runs the
    convolutions' first-order backwards, where one of ``torch.autograd.grad``
    with ``create_graph`` runs PyTorch's convolution double backward (its
    weight term a convolution with the batch as channels and the image as
    the kernel)."""
    c, h, w = net.shape
    b = x_full.shape[0]
    hcur = x_full[:, :-1].reshape(b, c, h, w)
    tt = x_full[:, -1].reshape(b, 1, 1, 1).expand(b, 1, h, w)
    last = len(net.layers) - 1
    slopes = []
    for i in range(last + 1):
        hcur = F.conv2d(torch.cat([tt, hcur], dim=1), params[f"layers.{i}.weight"],
                        params[f"layers.{i}.bias"], padding=1)
        if i != last:
            hcur, slope = _act_and_deriv(net.activation, hcur)
            slopes.append(slope)
    ejs = []
    for e in eps:
        g = e.reshape(b, c, h, w)
        for i in range(last, -1, -1):
            g = F.conv_transpose2d(g, params[f"layers.{i}.weight"][:, 1:], padding=1)
            if i:
                g = g * slopes[i - 1]
        ejs.append(g.reshape(b, -1))
    return hcur.reshape(b, -1), torch.stack(ejs)


def fused_dynamics_applicable(cfg: ICNFConfig, net, mode: Mode) -> bool:
    """The JAX fused-stage predicate with a float32 check in place of its
    TPU-backend check (the kernel takes float32; a float64 config solves
    unfused on every device, as JAX's does on the CPU), and batch-first only
    (JAX's factory returns the feature-first twin before it)."""
    return (
        cfg.fused
        and cfg.dtype == torch.float32
        and cfg.layout == "batch_first"
        and cfg.trace_for(mode) is TraceEstimator.HUTCH_VJP
        and cfg.nprobes == 1
        and isinstance(net, MLP)
        and len(net.widths) == 4
        and net.widths[1] == net.widths[2]
        and net.widths[1] <= MAX_HIDDEN
        and net.activation is F.softplus
    )


def make_augmented_dynamics(cfg: ICNFConfig, net: DynamicsNet, mode: Mode,
                            device_loop: bool = False) -> Callable:
    """Build ``f_aug(t, u, args) -> du`` for :func:`.ode.odeint`.

    ``args`` is ``{"params": dict, "eps": (P, B, nz) | None, "ys": (B, nc) | None}``;
    with ``cfg.layout == "feature_first"`` ``u`` is ``(state_dim, B)``, the
    probes ``(P, nz, B)`` and the conditions ``(nc, B)``.  ``device_loop``
    (the exported surfaces): a ``from_torch`` net's JVPs through its graph
    (:func:`_fx_jvps`) in place of forward mode."""
    nz = cfg.nz
    estimator = cfg.trace_for(mode)
    compute_reg_z = mode.regularized and cfg.norm_z
    compute_reg_j = mode.regularized and cfg.norm_j
    ff = cfg.layout == "feature_first"
    field = make_field_t(cfg, net) if ff else make_field(cfg, net)

    if fused_dynamics_applicable(cfg, net, mode):
        cdt = torch.bfloat16 if net.precision != "highest" else None

        def f_aug_fused(t, u: torch.Tensor, args: Args) -> torch.Tensor:
            x_full = _net_input(cfg, t, u[..., :nz], args.get("ys"))
            # the kernel takes the whole net: a tensor-parallel one's slices gathered
            dz, _epsj, div, reg_z, reg_j = fused_dynamics_vjp(
                x_full, args["eps"][0], pmesh.whole_mlp_params(args["params"]), nz, cdt
            )
            zero = torch.zeros_like(div)
            return torch.cat(
                [
                    dz,
                    -div[..., None],
                    (reg_z if compute_reg_z else zero)[..., None],
                    (reg_j if compute_reg_j else zero)[..., None],
                ],
                dim=-1,
            )

        return f_aug_fused

    planar = isinstance(net, Planar)
    conv_vjp = isinstance(net, ConcatConvNet) and not ff
    mlp_exact = _mlp_exact_applicable(net) and not compute_reg_j
    written = _written_net(net, fx=device_loop)
    sweep = estimator is TraceEstimator.EXACT and not planar and not mlp_exact
    feat = -2 if ff else -1  # the feature axis of z, of the probes and of their products
    norm = _col_norm if ff else _row_norm

    def f_aug(t, u: torch.Tensor, args: Args) -> torch.Tensor:
        params = args["params"]
        ys = args.get("ys")
        z = u[:nz] if ff else u[..., :nz]
        probes = probe_share(cfg)[2] if estimator is not TraceEstimator.EXACT else None
        sweeps = sweep and pmesh.model_share(cfg.sweep_axis, nz)[2] is not None
        if probes is not None or sweeps:
            # each model rank's share through the whole net: a tensor-parallel
            # one's slices gathered, their cotangents averaged over the ranks
            params = pmesh.whole_mlp_params(params, shares=True)
        zero = torch.zeros(z.shape[1:] if ff else z.shape[:-1], dtype=u.dtype, device=u.device)
        g = lambda zz: field(t, zz, params, ys)
        x_in = lambda: _net_input(cfg, t, z, ys, ff)
        if written is not None:
            jvps = lambda tangents: _written_jvps(*written, params, x_in(), nz, tangents, ff)
        else:
            jvps = lambda tangents: _jvps(g, z, tangents)
        reg_j = zero
        if estimator is TraceEstimator.EXACT and planar:
            dz, div, fro = _planar_trace(net, params, x_in(), nz, compute_reg_j, ff)
            reg_j = fro if compute_reg_j else zero
        elif estimator is TraceEstimator.EXACT and mlp_exact:
            dz, div = _mlp_exact_trace(net, params, x_in(), nz, ff)
        elif estimator is TraceEstimator.EXACT:
            dz, div, fro = _exact_sweep(jvps, z, nz, cfg.exact_chunk, compute_reg_j,
                                        cfg.sweep_axis, ff)
            reg_j = torch.sqrt(fro) if compute_reg_j else zero
        elif estimator is TraceEstimator.HUTCH_VJP:  # one shared forward, one VJP a probe
            eps = args["eps"]
            if conv_vjp:
                dz, eps_j = _conv_probe_vjps(net, params, x_in(), eps)
            else:
                dz, eps_j = _probe_vjps(g, z, eps, (*params.values(), ys))
            div = _probe_mean(torch.sum(eps_j * eps, dim=feat), cfg.nprobes, probes)
            reg_j = _probe_mean(norm(eps_j), cfg.nprobes, probes) if compute_reg_j else zero
        else:  # HUTCH_JVP: J eps by forward mode
            eps = args["eps"]
            dz, j_eps = jvps(eps)
            div = _probe_mean(torch.sum(eps * j_eps, dim=feat), cfg.nprobes, probes)
            reg_j = _probe_mean(norm(j_eps), cfg.nprobes, probes) if compute_reg_j else zero
        reg_z = norm(dz) if compute_reg_z else zero
        if ff:
            return torch.cat([dz, -div[None], reg_z[None], reg_j[None]], dim=0)
        return torch.cat(
            [dz, -div[..., None], reg_z[..., None], reg_j[..., None]], dim=-1
        )

    return f_aug
