"""Gradients through the ODE solve, dispatching on ``cfg.gradient``.

Counterpart of ``continuousnormalizingflows_tpu.ops.adjoint``:

* ``backprop``: autograd through the fixed-step loop (discretize, then
  optimize).
* ``adjoint`` (backsolve, the default): a ``torch.autograd.Function`` whose
  forward solves under ``no_grad`` and whose backward integrates the
  continuous adjoint state ``(y, a, q)`` from ``t1`` back to ``t0``::

      d/dt (y, a, q) = (f(t, y), -a^T df/dy, -a^T df/dtheta)

  with ``a(t1) = dL/dy1`` and ``q(t1) = 0``, giving ``a(t0) = dL/dy0`` and
  ``q(t0) = dL/dtheta``.
* ``quadrature``: the forward keeps the dense output of the solve; the
  backward integrates ``(a, q)`` only, reading ``y(t)`` off the interpolant.

Each evaluation of the backward takes the VJP of ``f`` with
``torch.autograd.grad`` on a detached ``y`` and the differentiable args under
``torch.enable_grad()``; with the fused dynamics (K1) that VJP is K2.  The
Hutchinson probe ``eps`` and the carried starting step ``dt0`` are not
differentiated (zero cotangent), as in the JAX package.

``graphs`` (a dict for one dynamics in one mode: ``ICNF.graphs``, which
``core._solve`` passes): a fixed-step backsolve on the card, outside a
sharded step, runs its forward solve and its backward solve as CUDA graphs,
each captured on the first call of its shapes (after two warm-up calls on a
side stream, which pick the convolutions' kernels) and replayed after it on
copies of the inputs: two launches a solve in place of one a product and
sum.  The replays run the eager solve's kernels on the same values, but
cuDNN's weight gradients may sum in another order from call to call: four
Adam steps of a replayed and an eager chain agree to 1.5e-5 of a step on
the card (``tests/test_torch_multiscale_cuda.py``).

Inside a sharded step (:func:`..parallel.mesh.use_mesh`) the parameter
leaves of the backward state, the parameter VJP and its integral ``q``, are
sums over this rank's rows.  Where they enter an error norm (no seminorm)
their VJP is all-reduced at every evaluation, as JAX's GSPMD does, so they
are alike on every rank and count once (a tensor-parallel MLP's split
leaves once a slice); otherwise ``q`` is all-reduced once at the end.
Either way the parameter gradient arrives summed over the ranks, and the
train step's bucket leaves it out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from ..config import DEFAULT_FIXED_DT0, SolverConfig
from ..parallel import mesh as pmesh
from ..utils import profiling
from .ode import SHARED, SPLIT, SolverStats, _leaves, eval_dense, odeint, odeint_dense

__all__ = ["odeint_diff"]

# args entries that get no cotangent on the continuous-adjoint paths: the
# probe, and the carried starting step (a solver-control scalar)
_NONDIFF_ARG_KEYS = ("eps", "dt0")


def _bwd_cfg(cfg: SolverConfig) -> SolverConfig:
    """The backward solve keeps the fixed-fraction start where the forward
    uses the HNW ``"auto"`` start (or the carry), as in the JAX package."""
    if isinstance(cfg.dt0, str):
        return dataclasses.replace(cfg, dt0=DEFAULT_FIXED_DT0)
    return cfg


def _bwd_dt0(args_nd):
    """The carried starting step of the forward, reused by the backward solve."""
    if isinstance(args_nd, dict):
        return args_nd.get("dt0")
    return None


def _split_args(args) -> Tuple[Any, Any]:
    """A dict ``args`` split into ``(differentiable, nondiff)``."""
    if isinstance(args, dict) and any(k in args for k in _NONDIFF_ARG_KEYS):
        nd = {k: v for k, v in args.items() if k in _NONDIFF_ARG_KEYS}
        d = {k: v for k, v in args.items() if k not in _NONDIFF_ARG_KEYS}
        return d, nd
    return args, None


def _merge_args(args_d, args_nd):
    if args_nd is None:
        return args_d
    return {**args_d, **args_nd}


def _flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """Tensor leaves of nested dicts/tuples/lists (``None`` is no leaf) and a
    function that rebuilds the tree from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"cannot differentiate through an argument of type {type(tree)}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_l, build), n in zip(parts, sizes):
            out.append(build(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [l for p in parts for l in p[0]], rebuild


def _param_keys(args_d) -> List[Optional[str]]:
    """The key under a dict's ``"params"`` of each leaf of the differentiable
    args that is a parameter (its VJP is a sum over the batch's rows), or
    None; ``""`` for a parameter leaf that has no key of its own."""
    if not isinstance(args_d, dict):
        return [None] * len(_flatten(args_d)[0])
    keys = []
    for k, v in args_d.items():
        if k == "params" and isinstance(v, dict):
            keys += [pk for pk, pv in v.items() for _ in _flatten(pv)[0]]
        else:
            keys += [("" if k == "params" else None)] * len(_flatten(v)[0])
    return keys


class _Sharding:
    """How a backward solve on a shard sums its parameter leaves (see the
    module's docstring): ``weight`` is the backward's ``error_weight``
    (``(y, a)`` leaves first when ``with_y``), ``per_eval`` whether the VJP
    is summed at every evaluation.  Summed over ``data``, a tensor-parallel
    MLP's split leaves still differ by model rank: they are :data:`SPLIT` in
    the norm, which then reduces over every rank (``global_mean``)."""

    def __init__(self, cfg: SolverConfig, keys, param_ids, n_y: int, with_y: bool):
        self.mask = [k is not None for k in keys]
        self.param_ids = param_ids
        head = (True,) * (2 * n_y if with_y else n_y)
        adaptive = cfg.method in ("dopri5", "tsit5", "abm")
        seminorm = cfg.adjoint_seminorm and adaptive
        sharded = pmesh.active() is not None and any(self.mask)
        self.per_eval = sharded and adaptive and not seminorm
        if seminorm:
            # the parameter quadrature q never feeds back: out of the norm
            self.weight = head + (False,) * len(keys)
        elif self.per_eval:
            self.weight = head + tuple(True if k is None else SPLIT if pmesh.is_split(k)
                                       else SHARED for k in keys)
        else:
            self.weight = None

    def each_eval(self, a_d):
        if self.per_eval:
            pmesh.sum_params_once([v for v, m in zip(a_d, self.mask) if m], ())
        return a_d

    def at_end(self, q):
        if self.per_eval:
            pmesh.active().summed.update(self.param_ids)
        elif pmesh.active() is not None:
            pmesh.sum_params_once([v for v, m in zip(q, self.mask) if m], self.param_ids)
        return q


def _vdot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _vjp(f, t, y_leaves, build_y, d_leaves, build_d, args_nd, cot):
    """``(f(t, y), a^T df/dy, a^T df/dargs)`` for ``a = cot`` (lists of leaves)."""
    with torch.enable_grad():
        y_ = [l.detach().requires_grad_() for l in y_leaves]
        d_ = [l.detach().requires_grad_() for l in d_leaves]
        dy, _ = _flatten(f(t, build_y(y_), _merge_args(build_d(d_), args_nd)))
        grads = torch.autograd.grad(dy, y_ + d_, cot, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, y_ + d_)]
    return [v.detach() for v in dy], grads[:len(y_)], grads[len(y_):]


def _end_grads(ctx, f, t0, t1, y1, g, y0_rec, a0, build_y, args):
    """``dL/dt1 = <g, f(t1, y1)>`` and ``dL/dt0 = -<a(t0), f(t0, y0)>``, each
    only where that end requires grad."""
    t0_bar = t1_bar = None
    with torch.no_grad():
        if ctx.needs_input_grad[1]:
            t1_bar = _vdot(g, _flatten(f(t1, build_y(y1), args))[0]).to(t1.dtype)
        if ctx.needs_input_grad[0]:
            t0_bar = (-_vdot(a0, _flatten(f(t0, build_y(y0_rec), args))[0])).to(t0.dtype)
    return t0_bar, t1_bar


class _Captured:
    """``fn(*inputs) -> (tensors, static)`` captured once as a CUDA graph on
    copies of ``inputs``; a call copies its inputs in, replays, and returns
    copies of the tensors and the capture's ``static`` (what does not vary
    between calls)."""

    def __init__(self, fn, inputs: List[torch.Tensor]) -> None:
        self.inputs = [x.detach().clone() for x in inputs]
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(self.inputs[0].device))
        with torch.cuda.stream(side):  # the warm-up picks the kernels outside the capture
            for _ in range(2):
                fn(*self.inputs)
        torch.cuda.current_stream(self.inputs[0].device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs, self.static = fn(*self.inputs)

    def __call__(self, inputs: List[torch.Tensor]):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return [o.clone() for o in self.outputs], self.static


def _capturable(cfg: SolverConfig, x: torch.Tensor) -> bool:
    """Whether a solve of ``cfg`` on ``x``'s device can be a CUDA graph: a
    fixed-step one (no host read) on the card, outside a sharded step."""
    return cfg.method in ("rk4", "euler") and x.is_cuda and pmesh.active() is None


def _replayed(graphs: Optional[dict], key: tuple, fn, inputs: List[torch.Tensor]):
    """``fn(*inputs) -> (tensors, static)``; with a ``graphs`` cache, where
    :func:`_capturable` (``key[1]`` the solve's config), through the graph
    captured there on the first call of these shapes."""
    if graphs is None or not _capturable(key[1], inputs[0]):
        return fn(*inputs)
    key = key + (inputs[0].device,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
    captured = graphs.get(key)
    if captured is None:
        captured = graphs[key] = _Captured(fn, inputs)
    return captured(inputs)


def _backward_solve(solve, inputs: List[torch.Tensor], cfg: SolverConfig,
                    graphs: Optional[dict]) -> list:
    """The leaves of a continuous adjoint's backward solve, ``solve(*inputs)``
    (the span ``adjoint.backward``), without a graph; replayed from
    ``graphs`` where :func:`_replayed` allows."""
    with torch.no_grad(), profiling.span("adjoint.backward"):
        return _replayed(graphs, ("bwd", cfg), solve, inputs)[0]


class _Backsolve(torch.autograd.Function):
    """The backsolve adjoint.  Inputs after the statics: ``t0``, ``t1`` (0-d
    tensors), the leaves of ``y0``, then those of the differentiable args."""

    @staticmethod
    def forward(ctx, t0, t1, static, *leaves):
        f, cfg, n_y, build_y, build_d, args_nd, stats_out, _shard, graphs = static
        nd, build_nd = _flatten(args_nd)
        n_in = len(leaves)

        def solve(t0, t1, *ins):
            args = _merge_args(build_d(list(ins[n_y:n_in])), build_nd(list(ins[n_in:])))
            y1, stats = odeint(f, build_y(list(ins[:n_y])), t0, t1, args, cfg)
            return _flatten(y1)[0] + [stats.dt_final], tuple(stats[:3])

        outs, counts = _replayed(graphs, ("fwd", cfg), solve, [t0, t1, *leaves, *nd])
        y1_leaves = outs[:-1]
        stats_out.append(SolverStats(*counts, outs[-1]))
        ctx.static = static
        ctx.save_for_backward(t0, t1, *y1_leaves, *leaves[n_y:])
        return tuple(y1_leaves)

    @staticmethod
    def backward(ctx, *g):
        f, cfg, n_y, build_y, build_d, args_nd, _stats, (keys, param_ids), graphs = ctx.static
        t0, t1, *saved = ctx.saved_tensors
        y1, d_leaves = saved[:n_y], saved[n_y:]
        g = [torch.zeros_like(y) if gi is None else gi for gi, y in zip(g, y1)]
        shard = _Sharding(cfg, keys, param_ids, n_y, with_y=True)
        nd, build_nd = _flatten(args_nd)
        n_in = 2 * n_y + len(d_leaves)

        def solve(t1, t0, *ins):
            d_in, nd_args = list(ins[2 * n_y:n_in]), build_nd(list(ins[n_in:]))

            def aug_dyn(t, state, _args):
                y, a = list(state[:n_y]), list(state[n_y:2 * n_y])
                dy, a_y, a_d = _vjp(f, t, y, build_y, d_in, build_d, nd_args, a)
                a_d = shard.each_eval(a_d)
                return tuple(dy) + tuple(-v for v in a_y) + tuple(-v for v in a_d)

            state1 = tuple(ins[:2 * n_y]) + tuple(torch.zeros_like(l) for l in d_in)
            state0, _stats = odeint(aug_dyn, state1, t1, t0, None, _bwd_cfg(cfg), shard.weight,
                                    dt0_override=_bwd_dt0(nd_args))
            return _leaves(state0), None

        state0 = _backward_solve(solve, [t1, t0, *y1, *g, *d_leaves, *nd], cfg, graphs)
        y0_rec, a0, q = state0[:n_y], state0[n_y:2 * n_y], shard.at_end(state0[2 * n_y:])
        full_args = _merge_args(build_d(list(d_leaves)), args_nd)
        t0_bar, t1_bar = _end_grads(ctx, f, t0, t1, y1, g, y0_rec, a0, build_y, full_args)
        return (t0_bar, t1_bar, None, *a0, *q)


class _Quadrature(torch.autograd.Function):
    """The interpolation (quadrature) adjoint: the forward keeps the dense
    output, the backward integrates ``(a, q)`` with ``y(t)`` read off it."""

    @staticmethod
    def forward(ctx, t0, t1, static, *leaves):
        f, cfg, n_y, build_y, build_d, args_nd, stats_out, _shard, _graphs = static
        y0 = build_y(list(leaves[:n_y]))
        y1, stats, dense = odeint_dense(f, y0, t0, t1,
                                        _merge_args(build_d(list(leaves[n_y:])), args_nd), cfg)
        stats_out.append(stats)
        y1_leaves, _ = _flatten(y1)
        ctx.static, ctx.dense = static, dense
        ctx.save_for_backward(t0, t1, *y1_leaves, *leaves[n_y:])
        return tuple(y1_leaves)

    @staticmethod
    def backward(ctx, *g):
        f, cfg, n_y, build_y, build_d, args_nd, _stats, (keys, param_ids), _graphs = ctx.static
        dense = ctx.dense
        t0, t1, *saved = ctx.saved_tensors
        y1, d_leaves = saved[:n_y], saved[n_y:]
        g = [torch.zeros_like(y) if gi is None else gi for gi, y in zip(g, y1)]
        shard = _Sharding(cfg, keys, param_ids, n_y, with_y=False)

        def adj_dyn(t, state, _args):
            y, _ = _flatten(eval_dense(dense, t))
            _dy, a_y, a_d = _vjp(f, t, y, build_y, d_leaves, build_d, args_nd,
                                 list(state[:n_y]))
            a_d = shard.each_eval(a_d)
            return tuple(-v for v in a_y) + tuple(-v for v in a_d)

        def solve(t1, t0, *state1):  # an adaptive solve: never captured
            state0, _stats = odeint(adj_dyn, state1, t1, t0, None, _bwd_cfg(cfg), shard.weight,
                                    dt0_override=_bwd_dt0(args_nd))
            return _leaves(state0), None

        state1 = list(g) + [torch.zeros_like(l) for l in d_leaves]
        state0 = _backward_solve(solve, [t1, t0, *state1], cfg, None)
        with torch.no_grad():
            y0_rec, _ = _flatten(eval_dense(dense, t0))
        a0, q = state0[:n_y], shard.at_end(state0[n_y:])
        full_args = _merge_args(build_d(list(d_leaves)), args_nd)
        t0_bar, t1_bar = _end_grads(ctx, f, t0, t1, y1, g, y0_rec, a0, build_y, full_args)
        return (t0_bar, t1_bar, None, *a0, *q)


def odeint_diff(f, y0, t0, t1, args, cfg: SolverConfig,
                graphs: Optional[dict] = None) -> Tuple[Any, SolverStats]:
    """Differentiable solve.  ``backprop`` is autograd through a fixed-step
    loop; ``adjoint`` (backsolve, any method) and ``quadrature`` (an
    adaptive method's dense output) are continuous adjoints.  On those two,
    the ``"eps"`` and ``"dt0"`` entries of a dict ``args`` get no cotangent
    (``backprop`` differentiates the probe).  ``graphs``: the caller's cache
    of CUDA graphs for ``f`` (see the module's docstring), or None."""
    if cfg.gradient == "backprop":
        return odeint(f, y0, t0, t1, args, cfg)
    args_d, args_nd = _split_args(args)
    y_leaves, build_y = _flatten(y0)
    d_leaves, build_d = _flatten(args_d)
    device = y_leaves[0].device
    tdt = y_leaves[0].dtype if y_leaves[0].dtype.is_floating_point else torch.float32
    if all(isinstance(t, torch.Tensor) and t.device == device for t in (t0, t1)):
        t0, t1 = t0.to(tdt), t1.to(tdt)
    else:
        # a float end is copied to the card from pageable memory: it waits for the stream
        with profiling.host_read("adjoint.times"):
            t0, t1 = (torch.as_tensor(t, dtype=tdt, device=device) for t in (t0, t1))
    needs = torch.is_grad_enabled() and any(
        t.requires_grad for t in (t0, t1, *y_leaves, *d_leaves))
    if not needs:
        # no cotangent can arrive: the plain solve, same values and stats
        with torch.no_grad():
            return odeint(f, y0, t0, t1, args, cfg)
    stats_out: List[SolverStats] = []
    fn = _Quadrature if cfg.gradient == "quadrature" else _Backsolve
    keys = _param_keys(args_d)
    shard = (keys, [id(l) for l, k in zip(d_leaves, keys) if k is not None])
    static = (f, cfg, len(y_leaves), build_y, build_d, args_nd, stats_out, shard, graphs)
    y1 = fn.apply(t0, t1, static, *y_leaves, *d_leaves)
    return build_y(list(y1)), stats_out[0]
