"""Device mesh, placements and the sharded train step, on ``torch.distributed``.

Counterpart of ``continuousnormalizingflows_tpu.parallel.mesh``.  JAX runs
one SPMD program over a mesh and lets XLA insert the collectives; here each
rank is a process that holds its own rows (and, with tensor parallelism, its
own slices of the net) as plain tensors, and the collectives are explicit,
on the groups of a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
axes are ``("data", "model")``.  The kernels take plain tensors, so nothing
here is a DTensor.

* :func:`shard_train_step` runs a step inside the mesh's **reduction
  context** (:func:`use_mesh`).  There the solvers' error norms all-reduce
  their ``(sum of squares, count)`` before the host reads them, so every rank
  takes the same adaptive steps as one process on the whole batch (JAX gets
  this from the norm being one reduction over the sharded state); the probes
  are drawn for the global batch and each rank keeps its rows; and the
  gradients are all-reduced once, in one flat bucket with the loss, before
  the optimizer step.
* ``model`` ranks either replicate the step (the default, as JAX's
  ``ICNFModel``), or split the probe ensemble (``probe_axis``) or the exact
  sweep (``sweep_axis``), or split the MLP Megatron-style
  (:func:`shard_mlp_params`, ``tensor_parallel=True``), or both: each rank
  then runs its share through the whole MLP, gathered.

The random streams stay in lockstep: every rank carries the same generator
state and draws what one process would draw for the whole batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from collections import Counter
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device
from ..utils import profiling

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch_arrays",
    "shard_train_step",
    "shard_mlp_params",
    "initialize_distributed",
]

Params = Dict[str, torch.Tensor]

# the keys a tensor-parallel MLP splits over ``model``, with the dim each is
# split along in the port's ``(out, in)`` layout (JAX: P(None, "model") on
# layer 0's ``(in, out)`` w, P("model") on its b, P("model", None) on layer
# 1's w); the rest is replicated
_TP_SPLIT = {"layers.0.weight": 0, "layers.0.bias": 0, "layers.1.weight": 1}


def initialize_distributed(**kwargs) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group(**kwargs)``.
    A no-op when a process group already exists or when no rendezvous is
    given (neither ``init_method`` nor ``store`` nor ``MASTER_ADDR`` in the
    environment), as JAX's is single-process.  ``backend`` defaults to
    ``"nccl"`` (the card); pass ``"gloo"`` for the CPU, or for CUDA tensors
    of several ranks on one card."""
    if dist.is_initialized():
        return
    if not ({"init_method", "store"} & set(kwargs) or "MASTER_ADDR" in os.environ):
        return
    kwargs.setdefault("backend", "nccl")
    dist.init_process_group(**kwargs)


def make_mesh(devices: Optional[Sequence[int]] = None, data: Optional[int] = None,
              model: int = 1, axis_names: Tuple[str, ...] = ("data", "model"),
              device=None) -> DeviceMesh:
    """A ``data x model`` mesh of ranks.  ``devices``: the ranks (default all
    of the world's); ``data`` defaults to ``len(devices) // model``.  In a
    plain single process this first sets up a world of 1 (NCCL on the card,
    gloo on the CPU).  ``device``: the mesh's device type, the card unless
    given ``"cpu"``; every rank of it uses its current CUDA device."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if data is None:
        data = len(ranks) // model
    if data < 1 or data * model > len(ranks):
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, "
                         f"{len(ranks)} given")
    grid = torch.tensor(ranks[: data * model], dtype=torch.int64).reshape(data, model)
    mesh = DeviceMesh(device.type, grid, mesh_dim_names=tuple(axis_names))
    # the group of every rank of the mesh: the loss, the gradients and the
    # error norms reduce over it (see _Shards)
    members = grid.flatten().tolist()
    mesh._cnf_all = (None if members == list(range(dist.get_world_size()))
                     else dist.new_group(members))
    return mesh


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's rows live on a mesh: split over ``axis``, or
    replicated (``axis=None``); JAX's ``NamedSharding`` of ``P(axis)``."""

    mesh: DeviceMesh
    axis: Optional[str]


def data_sharding(mesh: DeviceMesh) -> Placement:
    """Batch-major tensors: rows split along the ``data`` axis."""
    return Placement(mesh, "data")


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, None)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows_of(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    n, size = x.shape[0], mesh.size(0)
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over the {size} ranks of "
                         f"the mesh's data axis")
    per = n // size
    r = mesh.get_local_rank(0)
    return x[r * per:(r + 1) * per].to(mesh_device(mesh))


def shard_batch_arrays(mesh: DeviceMesh, xs: torch.Tensor, ys: Optional[torch.Tensor] = None):
    """This rank's rows of the dataset ``xs`` (and ``ys``), split over the
    ``data`` axis, on the mesh's device.  Raises where the rows do not
    divide by the axis's size."""
    return _rows_of(mesh, xs), None if ys is None else _rows_of(mesh, ys)


def host_local_batch(mesh: DeviceMesh, local_xs: torch.Tensor) -> torch.Tensor:
    """Per-process loading: ``local_xs`` is this rank's rows (no process
    holds the global batch), which has ``data * rows`` rows.  Checks, in one
    collective, that every rank holds as many rows; returns the local rows
    on the mesh's device.  In a world of 1 they are the batch."""
    local = torch.as_tensor(local_xs).to(mesh_device(mesh))
    n = torch.tensor([local.shape[0], -local.shape[0]], dtype=torch.float64,
                     device=local.device)
    _all_reduce(n, mesh.get_group("data"), dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        raise ValueError(f"the ranks hold {-int(n[1])} to {int(n[0])} rows: a batch split "
                         f"over the data axis needs as many on every rank")
    return local


# ---- the model axis: tensor-parallel MLP params ----

def shard_mlp_params(mesh: DeviceMesh, params: Params) -> Params:
    """This rank's slices of an MLP's params for tensor parallelism over the
    ``model`` axis (Megatron's scheme): layer 0 split by its output units,
    layer 1 by its input units, the rest replicated.  With one ``model``
    rank, the params as they are.  :func:`gather_mlp_params` is the inverse."""
    m = mesh.size(1)
    if m == 1:
        return dict(params)
    r = mesh.get_local_rank(1)
    out = {}
    for k, v in params.items():
        if k in _TP_SPLIT:
            dim = _TP_SPLIT[k]
            if v.shape[dim] % m:
                raise ValueError(f"{k} has {v.shape[dim]} units along dim {dim}: they do "
                                 f"not split over {m} model ranks")
            per = v.shape[dim] // m
            v = v.narrow(dim, r * per, per)
        out[k] = v.detach().clone()
    return out


def gather_mlp_params(mesh: DeviceMesh, params: Params) -> Params:
    """The inverse of :func:`shard_mlp_params`: every rank's slices gathered
    into the whole params (one all-gather a split tensor)."""
    if mesh.size(1) == 1:
        return dict(params)
    g = mesh.get_group("model")
    return {k: (_gather(v.detach(), _TP_SPLIT[k], g) if k in _TP_SPLIT else v.detach().clone())
            for k, v in params.items()}


def _gather(v: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
    _count("all_gather")
    dist.all_gather(parts, v.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ---- the reduction context ----

@dataclasses.dataclass
class _Shards:
    """What a step's collectives need: the mesh's groups and this rank's
    place in them.  ``group``/``size``: every rank of the mesh, over which the
    loss and (without tensor parallelism) the gradients reduce.  The error
    norms reduce over ``data`` alone: the model ranks of a data shard hold
    its rows alike.  ``summed``: ids of the params whose gradients arrive
    already summed over the ranks (the adjoint's), which the bucket leaves
    out.  ``counts``: the collectives issued, by site."""

    tensor_parallel: bool
    group: object
    size: int
    data: object
    data_size: int
    data_rank: int
    model: object
    model_size: int
    model_rank: int
    summed: set = dataclasses.field(default_factory=set)
    tp_sharded: set = dataclasses.field(default_factory=set)  # ids of split params
    counts: Counter = dataclasses.field(default_factory=Counter)
    serving: bool = False  # the exported program's: functional collectives

    @property
    def grad_group(self):
        """Where the gradients reduce: ``data`` under tensor parallelism
        (the split layers' gradients differ by model rank), else every rank."""
        return self.data if self.tensor_parallel else self.group

    @property
    def grad_size(self) -> int:
        return self.data_size if self.tensor_parallel else self.size

    @property
    def replicas(self) -> int:
        """Copies of each data shard's sum in a sum over ``grad_group``: the
        model ranks, unless they split the net."""
        return 1 if self.tensor_parallel else self.model_size


_ACTIVE: Optional[_Shards] = None


def active() -> Optional[_Shards]:
    """The reduction context of the step running now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, tensor_parallel: bool = False,
             serving: bool = False) -> Iterator[_Shards]:
    """Run the solvers, the losses and the nets on this rank's shard: the
    counterpart of ``jax.set_mesh`` and of a jitted step's shardings.  Inside,
    ``inference``/``loss`` take this rank's rows and agree with one process
    on the whole batch; ``probe_axis``/``sweep_axis`` name ``"model"``.
    ``serving``: the context of an exported program (``export_logpdf(mesh=)``):
    the error norms reduce by a functional all-reduce, which ``torch.export``
    captures inside the device loop, and the ``model`` ranks replicate."""
    global _ACTIVE
    if tuple(mesh.mesh_dim_names or ()) != ("data", "model"):
        raise ValueError(f"the port's mesh axes are ('data', 'model'), got "
                         f"{mesh.mesh_dim_names}")
    model = (None, 1, 0) if serving else (mesh.get_group("model"), mesh.size(1),
                                          mesh.get_local_rank(1))
    ctx = _Shards(bool(tensor_parallel) and mesh.size(1) > 1, getattr(mesh, "_cnf_all", None),
                  mesh.size(), mesh.get_group("data"), mesh.size(0), mesh.get_local_rank(0),
                  *model, serving=serving)
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def _count(site: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.counts[site] += 1


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM, site: str = "all_reduce"):
    """In place, counted by ``site``."""
    _count(site)
    dist.all_reduce(t, op=op, group=group)
    return t


def global_mean(total, count: int, total_shared=0.0, count_shared: int = 0,
                total_split=0.0, count_split: int = 0):
    """``total / count`` over the active mesh's data shards, in one
    collective (an error norm's sum of squares, a loss's sum): ``total`` and
    ``count`` are this rank's share of a quantity whose rows are split over
    the ``data`` axis, ``total_shared``/``count_shared`` one that every rank
    holds alike (counted once, by the first data rank).  The reduction runs
    over ``data`` alone: the ``model`` ranks of a data shard hold its rows
    alike and each reads the same mean.  ``total_split``/``count_split``:
    a tensor-parallel MLP's split leaves (the adjoint's parameter leaves
    without the seminorm), alike over ``data`` and sliced over ``model``;
    with them the reduction runs over every rank of the mesh, the rows
    counted by the first model rank, the shared part by the first rank, the
    slices by the first data rank.  ``total`` (a float32 tensor) may hold
    several sums at once.  Without a mesh, the local mean."""
    ctx = _ACTIVE
    if ctx is None:
        return (total + total_shared + total_split) / (count + count_shared + count_split)
    if count_split:
        group = ctx.group
        parts = ((total, count, ctx.model_rank == 0),
                 (total_shared, count_shared, ctx.data_rank == 0 and ctx.model_rank == 0),
                 (total_split, count_split, ctx.data_rank == 0))
    else:
        group = ctx.data
        parts = ((total, count, True), (total_shared, count_shared, ctx.data_rank == 0))
    # a rank that counts none of the parts adds zeros of the sums' shape
    total = torch.zeros_like(next(t for t, _c, _o in parts if torch.is_tensor(t)))
    count = 0
    for t, c, own in parts:
        if own:
            total, count = total + t, count + c
    # the count as a tensor without reading it as a float: under torch.export
    # it is symbolic in the batch
    buf = torch.cat([total.to(torch.float64).reshape(-1),
                     torch.ones(1, dtype=torch.float64, device=total.device) * count])
    if ctx.serving:  # traced once, run every trial step: not counted
        from torch.distributed import _functional_collectives as funcol

        buf = funcol.all_reduce(buf, "sum", group)
    else:
        _all_reduce(buf, group, site="norm")
    return (buf[:-1] / buf[-1]).to(torch.float32).reshape(total.shape)


def reduce_max(t: torch.Tensor, site: str = "stats") -> torch.Tensor:
    """Elementwise max over every rank of the active mesh (a copy)."""
    out = t.clone()
    return _all_reduce(out, _ACTIVE.group, dist.ReduceOp.MAX, site) if _ACTIVE else out


def sum_params_once(leaves, params_ids) -> None:
    """All-reduce (in place, one bucket) gradients that are sums over this
    rank's rows into the sums over the batch, and note that the params with
    ``params_ids`` need no reduction in the train step's bucket."""
    ctx = _ACTIVE
    if ctx is None or not leaves:
        return
    flat = torch.cat([l.reshape(-1) for l in leaves])
    _all_reduce(flat, ctx.grad_group, site="param_vjp")
    if ctx.replicas > 1:
        flat = flat / ctx.replicas
    i = 0
    for l in leaves:
        l.copy_(flat[i:i + l.numel()].view_as(l))
        i += l.numel()
    ctx.summed.update(params_ids)


# ---- differentiable collectives over the model axis ----

class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward (the input of
    a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward (after a
    row-parallel product).  Each backward calls the other Function, so both
    are differentiable twice (the probe VJP under ``create_graph``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group, site="model")

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    """The sum of every model rank's share, held by each: all-reduce forward
    and backward (its own VJP), for a share of the probes or the sweep whose
    sum each rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group, site="model")

    @staticmethod
    def backward(ctx, g):
        return _SumOverModel.apply(g, ctx.group), None


class _GatherModel(torch.autograd.Function):
    """A tensor-parallel slice gathered whole over ``model`` (before a fused
    kernel, which takes the whole net); backward keeps this rank's slice of
    the cotangent, which every model rank computes alike.  ``shares``: the
    model ranks split the probes or the sweep, so each rank's cotangent
    holds the part alike on every rank (the field's) and its own shares'
    part, taken ``model`` times by :class:`_SumOverModel`'s backward: it is
    summed over ``model`` and divided by the ranks before the slice is kept."""

    @staticmethod
    def forward(ctx, v, dim, group, shares):
        ctx.dim, ctx.n, ctx.group, ctx.shares = dim, v.shape[dim], group, shares
        return _gather(v, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.shares:
            g = _mean_over(g, ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n), None, None, None


class _ReplicaOverModel(torch.autograd.Function):
    """A replicated leaf where the model ranks split the probes or the sweep:
    identity forward; backward the mean of the ranks' cotangents, as
    :class:`_GatherModel` takes them with ``shares``."""

    @staticmethod
    def forward(ctx, v, group):
        ctx.group = group
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g, ctx.group), None


def _mean_over(g: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(g.contiguous().clone(), group, site="model") / dist.get_world_size(group)


def tp_group():
    """The ``model`` group where the active step splits the MLP, else None."""
    return _ACTIVE.model if _ACTIVE is not None and _ACTIVE.tensor_parallel else None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def model_share(axis: Optional[str], n: int) -> Tuple[int, int, object]:
    """``(start, stop, group)`` of this rank's share of ``n`` items split over
    the mesh axis ``axis`` (``probe_axis``/``sweep_axis``): ``(0, n, None)``
    where nothing is split.  Shares are ``ceil(n / ranks)`` long, the last
    one cut short.  Under tensor parallelism each rank runs its share
    through the whole MLP (:func:`whole_mlp_params` with ``shares=True``)."""
    ctx = _ACTIVE
    if axis is None or ctx is None:
        return 0, n, None
    if axis != "model":
        raise ValueError(f"the port's mesh splits the probes or the sweep over 'model', "
                         f"got axis {axis!r}")
    if ctx.model_size == 1:
        return 0, n, None
    per = -(-n // ctx.model_size)
    start = min(ctx.model_rank * per, n)
    return start, min(start + per, n), ctx.model


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of every model rank's ``x`` (identity without a group)."""
    return x if group is None else _SumOverModel.apply(x, group)


def whole_mlp_params(params: Params, shares: bool = False) -> Params:
    """The whole MLP under tensor parallelism (its slices gathered,
    differentiably), for the kernels that take the whole net, and for the
    model ranks' shares of the probes or the sweep (``shares=True``: the
    cotangents averaged over ``model``, see :class:`_GatherModel`); the
    params as they are otherwise."""
    g = tp_group()
    if g is None:
        return params
    return {k: (_GatherModel.apply(v, _TP_SPLIT[k], g, shares) if k in _TP_SPLIT
                else _ReplicaOverModel.apply(v, g) if shares else v)
            for k, v in params.items()}


def is_split(key: str) -> bool:
    """Whether the active step holds the MLP leaf ``key`` as this rank's
    slice (tensor parallelism)."""
    return tp_group() is not None and key in _TP_SPLIT


# ---- the sharded train step ----

def _tp_sharded(params: Params) -> set:
    return {id(v) for k, v in params.items() if k in _TP_SPLIT}


def shard_train_step(step: Callable, mesh: DeviceMesh, conditional: bool = False,
                     tensor_parallel: bool = False, n_extra_repl: int = 0) -> Callable:
    """Wrap a loss step for the mesh.  ``step(params, generator, xs, ys,
    *extra) -> (loss, *aux)`` computes this rank's loss, the mean over its
    rows; the returned ``sharded(params, optimizer, generator, xs, ys,
    *extra) -> (loss, *aux)`` runs it inside the mesh's reduction context
    (:func:`use_mesh`), takes the backward there, all-reduces the gradients
    with the loss once (one flat bucket, divided by the ranks it summed),
    then takes the optimizer's step, the same on every rank.  ``xs``/``ys``
    are this rank's rows (``ys`` passes as None unless ``conditional``); the
    returned loss is the global mean.  ``tensor_parallel``: the params are
    :func:`shard_mlp_params`' slices, the gradients reduce over ``data``
    only and the optimizer's global-norm clip sums the slices' squares over
    ``model``.  ``n_extra_repl``: trailing arguments every rank holds alike
    (the carried start ``dt0``).  The last call's collectives, by site, are
    in ``sharded.counts``."""

    def sharded(params: Params, optimizer, generator, xs, ys=None, *extra):
        if len(extra) != n_extra_repl:
            raise TypeError(f"the step takes {n_extra_repl} replicated trailing "
                            f"argument(s), got {len(extra)}")
        optimizer.zero_grad(set_to_none=True)
        with use_mesh(mesh, tensor_parallel) as ctx:
            loss, *aux = step(params, generator, xs, ys if conditional else None, *extra)
            loss.backward()
            ctx.tp_sharded = _tp_sharded(params) if ctx.tensor_parallel else set()
            loss = _reduce_bucket(ctx, list(params.values()), loss.detach())
            with profiling.span("optimizer.step"):
                optimizer.step()
        sharded.counts = dict(ctx.counts)
        return (loss, *aux)

    sharded.counts = {}
    return sharded


def _reduce_bucket(ctx: _Shards, tensors, loss: torch.Tensor) -> torch.Tensor:
    """One all-reduce of the loss and of every gradient not summed already,
    then each divided by the ranks summed, and the gradients summed over the
    batch already (the adjoint's) by the data ranks: the global mean loss and
    the gradient of the global mean."""
    with profiling.span("bucket"):
        todo = [p.grad for p in tensors if p.grad is not None and id(p) not in ctx.summed]
        flat = torch.cat([loss.reshape(1).to(torch.float32)]
                         + [g.reshape(-1).to(torch.float32) for g in todo])
        _all_reduce(flat, ctx.grad_group, site="grad")
        flat = flat / ctx.grad_size
        i = 1
        for g in todo:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        for p in tensors:
            if p.grad is not None and id(p) in ctx.summed:
                p.grad.div_(ctx.data_size)
        return flat[0].to(loss.dtype)


def clip_sq_norm(params_and_grads) -> torch.Tensor:
    """The squared global norm of the gradients, as the optimizer's
    global-norm clip reads it: the local sum (the gradients are already
    reduced over ``data``), except that under tensor parallelism the split
    layers' squares are summed over ``model`` and the replicated ones counted
    once, as JAX's clip sees its global arrays."""
    pairs = list(params_and_grads)
    ctx = _ACTIVE
    if ctx is None or not ctx.tensor_parallel:
        return sum(torch.sum(g * g) for _p, g in pairs)
    split = ctx.tp_sharded
    zero = torch.zeros((), dtype=pairs[0][1].dtype, device=pairs[0][1].device)
    sq_split = sum((torch.sum(g * g) for p, g in pairs if id(p) in split), zero)
    sq_repl = sum((torch.sum(g * g) for p, g in pairs if id(p) not in split), zero)
    return _all_reduce(sq_split.clone(), ctx.model, site="clip") + sq_repl
