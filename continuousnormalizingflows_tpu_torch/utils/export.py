"""Serving export: a fitted flow as a standalone ``torch.export`` artifact.

Counterpart of ``continuousnormalizingflows_tpu.utils.export``.  A fitted
ICNF is captured by :func:`torch.export.export` into a program with its
parameters inside: a serving process runs it with ``torch`` alone
(``torch.export.load(path).module()(x)``), with no model code, config
objects or parameter files.  The solve runs through the device-loop form of
the solvers (:func:`..ops.ode.odeint_device`: dopri5, tsit5, abm and the
fixed-step methods as one ``while_loop`` each), so the program holds no host
read.

* :func:`export_logpdf`: ``x (b, nvariables) [, ys (b, nconditions)] ->
  logp (b,)``, the exact-trace (TEST) log-density, with a symbolic batch
  dimension: one artifact serves any batch.  With ``mesh=`` each rank of a
  ``data x model`` mesh exports and serves its shard of the batch; the
  adaptive controllers' error norms are all-reduced over ``data`` inside
  the loop, so every rank takes the unsharded solve's steps.
* :func:`export_sampler`: ``seed -> samples (n, nvariables)``, ``n`` fixed
  at export.  A traced program cannot take a ``torch.Generator``, so the
  program draws from the default generator of its device, and
  :meth:`Artifact.call` seeds that generator under
  ``torch.random.fork_rng``: the same seed gives the same bits as the eager
  ``generate(icnf, Mode.TEST, params, torch.Generator(device).manual_seed(seed),
  n, trace_free=...)``, also for a Student-t base (its rejection rounds run in
  a ``while_loop``).

The program runs on the device it was exported for (``device``; default the
card).  A ``layout="feature_first"`` config exports its feature-first solve,
the symbolic batch on axis 1 of the state inside the loop.  The exact trace
of a ``from_torch`` net exports through its ``torch.fx`` graph with the
tangents carried node by node (:func:`..ops.dynamics.fx_refusal` names the
ops it covers).  Not exported, each raising at export time: a
``from_torch`` net that ``torch.fx`` cannot trace or whose graph holds
another op (its trace-free sampler exports); an activation without a
written-out derivative (:data:`..ops.dynamics.ACTIVATION_DERIVATIVES`); and
a user's base distribution whose sampler reads the device.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import torch

from ..config import Mode, resolve_device
from ..core import generate, inference
from ..distributions import DefaultGenerator

__all__ = ["Artifact", "export_logpdf", "export_sampler", "save_artifact", "load_artifact"]

_META = "cnf_artifact.json"  # the artifact's kind, device and mesh, beside the program


class _Served(torch.nn.Module):
    """The parameters as buffers and one TEST surface as ``forward``."""

    def __init__(self, icnf, params: Dict[str, torch.Tensor], device, fn) -> None:
        super().__init__()
        self.icnf, self.fn, self.names = icnf, fn, list(params)
        for i, v in enumerate(params.values()):
            self.register_buffer(f"p{i}", v.detach().to(device))

    def forward(self, *xs):
        params = {k: getattr(self, f"p{i}") for i, k in enumerate(self.names)}
        with torch.no_grad():
            return self.fn(self.icnf, params, *xs)


class Artifact:
    """An exported program and what it serves: ``.call(...)`` runs it
    (``x[, ys] -> logp`` or ``seed -> samples``), ``.program`` is the
    :class:`torch.export.ExportedProgram`.  ``mesh``: ``(data, model)`` and
    the name of the ``data`` process group the program's all-reduce names,
    for an ``export_logpdf(mesh=)`` artifact; else None."""

    def __init__(self, program, kind: str, device,
                 mesh: Optional[Tuple[Tuple[int, int], str]] = None) -> None:
        self.program, self.kind, self.device = program, kind, torch.device(device)
        self.mesh = None if mesh is None else (tuple(mesh[0]), str(mesh[1]))
        self._module = program.module()

    def call(self, *args):
        if self.kind == "logpdf":
            return self._module(*args)
        (seed,) = args
        cuda = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[self.device.index or 0] if cuda else [],
                                   device_type=self.device.type):
            if cuda:  # the program's device alone, as torch.Generator(device) is
                with torch.cuda.device(self.device):
                    torch.cuda.manual_seed(int(seed))
            else:
                torch.default_generator.manual_seed(int(seed))
            return self._module()


def _check_exportable(icnf, exact_trace: bool) -> None:
    """Raise where the program would take the exact trace of a net whose
    sweep ``torch.export`` does not capture: an activation without a
    written-out derivative, or a ``from_torch`` net whose graph the written-out
    forward mode does not cover (``torch.fx`` cannot trace it, or a node
    outside :func:`..ops.dynamics.fx_refusal`'s set, named)."""
    from ..models.nets import CondLayer, _TorchNet
    from ..ops.dynamics import activation_name, exact_trace_traceable, fx_refusal

    if not exact_trace or exact_trace_traceable(icnf.net):
        return
    name = activation_name(icnf.net)
    if name is not None:
        raise NotImplementedError(
            f"the activation {name} has no written-out derivative, and autograd inside the "
            f"exported solve is not captured: use one of ops.dynamics.ACTIVATION_DERIVATIVES "
            f"(softplus, tanh, sigmoid, relu, elu, gelu, silu)")
    net = icnf.net
    while isinstance(net, CondLayer):
        net = net.net
    why = (fx_refusal(net) if isinstance(net, _TorchNet)
           else f"a {type(net).__name__} is neither an MLP, a Planar nor a from_torch net")
    raise NotImplementedError(
        f"the exact trace of this net does not export: {why}.  A from_torch net's "
        f"forward mode is written out node by node for nn.Linear/F.linear, the activations of "
        f"ops.dynamics.ACTIVATION_DERIVATIVES, +, -, * by a tangent-free operand, negation, "
        f"torch.cat, torch.stack, indexing and reshape/view; forward mode by autograd is not "
        f"captured with a symbolic batch.  The sampler with trace_free=True exports")


def _logpdf(icnf, params, x, ys=None):
    return inference(icnf, Mode.TEST, x, params, ys=ys, device_loop=True)[0]


def _logpdf_and_stats(icnf, params, x, ys=None):
    """``(logp, nfe, naccept, nreject)``: the log-density and what the solve
    cost, the counts as 0-d int64 tensors (the smoke and the tests hold a
    served call's steps against the eager call's)."""
    logp, _augs, st = inference(icnf, Mode.TEST, x, params, ys=ys, device_loop=True)
    count = lambda v: torch.as_tensor(v, dtype=torch.int64, device=logp.device)
    return logp, count(st.nfe), count(st.naccept), count(st.nreject)


def export_logpdf(icnf, params: Dict[str, torch.Tensor], device=None, mesh=None) -> Artifact:
    """Export the exact (TEST) log-density with ``params`` inside.  The batch
    dimension is symbolic; for a conditional model the program is ``(x, ys)
    -> logp``.  ``device``: where the program runs (default: the card).

    ``mesh``: a ``data x model`` mesh (:func:`..parallel.make_mesh`) for
    serving across ranks, the counterpart of JAX's SPMD export.  Every rank
    calls this and gets its own program, which takes this rank's rows
    (:func:`..parallel.shard_batch_arrays` of a global batch, a multiple of
    the ``data`` size) on the mesh's device and returns their
    log-densities; the ``model`` ranks of a data shard replicate it.  The
    adaptive controllers' error norm is all-reduced over ``data`` inside the
    device loop, so every rank takes the unsharded solve's steps.  The
    program names the ``data`` process group it reduces over: a serving
    process that loads a saved artifact must first set up the same world
    (``torch.distributed.init_process_group`` with the same world size and
    rank) and build the same mesh the same way, so that the group gets the
    same name; :func:`load_artifact` checks the shape and the name."""
    return _export_logpdf(icnf, params, device, mesh, _logpdf)


def _export_logpdf(icnf, params, device=None, mesh=None, fn=_logpdf_and_stats) -> Artifact:
    """:func:`export_logpdf` with ``fn(icnf, params, x[, ys])`` as the served
    surface."""
    import contextlib

    from ..parallel import mesh as pmesh

    _check_exportable(icnf, exact_trace=True)
    cfg = icnf.config
    device = resolve_device(device) if mesh is None else pmesh.mesh_device(mesh)
    served = _Served(icnf, params, device, fn)
    widths = (cfg.nvariables, cfg.nconditions) if cfg.conditioned else (cfg.nvariables,)
    inputs = tuple(torch.zeros((2, w), dtype=cfg.dtype, device=device) for w in widths)
    batch = torch.export.Dim("batch")
    sharded = (contextlib.nullcontext() if mesh is None
               else pmesh.use_mesh(mesh, serving=True))
    with sharded:
        program = torch.export.export(served, inputs,
                                      dynamic_shapes=(tuple({0: batch} for _ in inputs),))
    recorded = None if mesh is None else (tuple(mesh.shape), mesh.get_group("data").group_name)
    return Artifact(program, "logpdf", device, recorded)


def export_sampler(icnf, params: Dict[str, torch.Tensor], n: int, ys=None,
                   trace_free: bool = True, device=None) -> Artifact:
    """Export the sampling path, ``seed -> (n, nvariables)``, ``n`` fixed here.
    ``trace_free=True`` (default) integrates the bare field.  A conditional
    model bakes in ``ys`` (one condition row, or ``n`` of them).  The base
    distribution's sampler must trace: a user's sampler that reads the
    device (a rejection loop with a host read) raises here; the built-in
    Student-t base runs its rounds in a ``while_loop``."""
    _check_exportable(icnf, exact_trace=not trace_free)
    cfg = icnf.config
    if cfg.conditioned and ys is None:
        raise ValueError("conditional model: pass ys to bake into the sampler")
    device = resolve_device(device)
    ys = None if ys is None else torch.as_tensor(ys, dtype=cfg.dtype, device=device)
    n = int(n)
    served = _Served(icnf, params, device, lambda m, p: generate(
        m, Mode.TEST, p, DefaultGenerator(device), n, ys=ys, trace_free=trace_free,
        device_loop=True))
    try:
        program = torch.export.export(served, ())
    except torch.fx.experimental.symbolic_shapes.GuardOnDataDependentSymNode as err:
        raise ValueError(
            "the sampler reads the device while it draws (a data-dependent host loop, "
            "e.g. a rejection sampler that reads its mask) and cannot be exported; draw "
            "its rounds in a while_loop, as distributions.student_t does"
        ) from err
    return Artifact(program, "sampler", device)


def save_artifact(path: str, artifact: Artifact) -> None:
    """Write the program (``torch.export.save``) with its kind, device and
    mesh."""
    meta = json.dumps({"kind": artifact.kind, "device": str(artifact.device),
                       "mesh": None if artifact.mesh is None else list(artifact.mesh)})
    torch.export.save(artifact.program, path, extra_files={_META: meta})


def load_artifact(path: str, mesh=None) -> Artifact:
    """Load an artifact; ``.call(...)`` runs it (no model code needed).  An
    ``export_logpdf(mesh=)`` artifact needs ``mesh``: one of the recorded
    shape whose ``data`` group has the name the program reduces over (the
    same world, the mesh built the same way); anything else raises."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    recorded = meta.get("mesh")
    if recorded is not None:
        shape, group = tuple(recorded[0]), recorded[1]
        got = None if mesh is None else (tuple(mesh.shape), mesh.get_group("data").group_name)
        if got != (shape, group):
            raise ValueError(
                f"the artifact was exported on a {shape[0]} x {shape[1]} mesh whose data group "
                f"is named {group!r}; load it with such a mesh (got {got}): set up the same "
                f"world and build the mesh the same way first")
        recorded = (shape, group)
    elif mesh is not None:
        raise ValueError("the artifact was exported without a mesh")
    return Artifact(program, meta["kind"], meta["device"], recorded)
