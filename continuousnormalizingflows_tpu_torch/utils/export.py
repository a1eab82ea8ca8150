"""Serving export: a fitted flow as a standalone ``torch.export`` artifact.

Counterpart of ``continuousnormalizingflows_tpu.utils.export``.  A fitted
ICNF is captured by :func:`torch.export.export` into a program with its
parameters inside: a serving process runs it with ``torch`` alone
(``torch.export.load(path).module()(x)``), with no model code, config
objects or parameter files.  The solve runs through the device-loop form of
the solvers (:func:`..ops.ode.odeint_device`: the adaptive loop is one
``while_loop``), so the program holds no host read.

* :func:`export_logpdf`: ``x (b, nvariables) [, ys (b, nconditions)] ->
  logp (b,)``, the exact-trace (TEST) log-density, with a symbolic batch
  dimension: one artifact serves any batch.
* :func:`export_sampler`: ``seed -> samples (n, nvariables)``, ``n`` fixed
  at export.  A traced program cannot take a ``torch.Generator``, so the
  program draws from the default generator of its device, and
  :meth:`Artifact.call` seeds that generator under
  ``torch.random.fork_rng``: the same seed gives the same bits as the eager
  ``generate(icnf, Mode.TEST, params, torch.Generator(device).manual_seed(seed),
  n, trace_free=...)``.

The program runs on the device it was exported for (``device``; default the
card).  Not exported, each raising at export time (ROADMAP.md, Queue 1):
the abm solver (its order is kept on the host); the exact trace of a net
that needs the generic sweep (forward-mode AD) or an activation
differentiated by autograd (:func:`..ops.dynamics.exact_trace_traceable`);
a base distribution whose sampler reads the device (the Student-t rejection
gamma); and ``export_logpdf(mesh=)``, which needs collectives inside the
device loop (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from ..config import Mode, resolve_device
from ..core import generate, inference
from ..distributions import DefaultGenerator

__all__ = ["Artifact", "export_logpdf", "export_sampler", "save_artifact", "load_artifact"]

_META = "cnf_artifact.json"  # the artifact's kind and device, beside the program


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
    :class:`torch.export.ExportedProgram`."""

    def __init__(self, program, kind: str, device) -> None:
        self.program, self.kind, self.device = program, kind, torch.device(device)
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


def _check_exportable(icnf, mesh, exact_trace: bool) -> None:
    """Raise for what does not export: ``mesh=`` (the logpdf's), the abm
    solver, and (where the program takes the exact trace) a net whose exact
    trace does not trace."""
    from ..ops.dynamics import exact_trace_traceable

    if mesh is not None:
        raise NotImplementedError(
            "export_logpdf(mesh=) needs collectives inside the exported device loop "
            "(torch.export of a while_loop) and is not ported yet (ROADMAP.md, Queue 1 "
            "item 7: parallel)")
    if icnf.config.solver.method == "abm":
        raise NotImplementedError(
            "the abm solver keeps its order on the host and is not exported yet "
            "(ROADMAP.md, Queue 1)")
    if exact_trace and not exact_trace_traceable(icnf.net):
        raise NotImplementedError(
            "the exact trace of this net does not trace for torch.export: the generic "
            "sweep (forward-mode JVPs) and activations differentiated by autograd are not "
            "captured; the planar net and the MLP with 1-2 hidden layers, softplus or "
            "tanh, export (ROADMAP.md, Queue 1)")


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
    -> logp``.  ``device``: where the program runs (default: the card)."""
    return _export_logpdf(icnf, params, device, mesh, _logpdf)


def _export_logpdf(icnf, params, device=None, mesh=None, fn=_logpdf_and_stats) -> Artifact:
    """:func:`export_logpdf` with ``fn(icnf, params, x[, ys])`` as the served
    surface."""
    _check_exportable(icnf, mesh, exact_trace=True)
    cfg = icnf.config
    device = resolve_device(device)
    served = _Served(icnf, params, device, fn)
    widths = (cfg.nvariables, cfg.nconditions) if cfg.conditioned else (cfg.nvariables,)
    inputs = tuple(torch.zeros((2, w), dtype=cfg.dtype, device=device) for w in widths)
    batch = torch.export.Dim("batch")
    program = torch.export.export(served, inputs,
                                  dynamic_shapes=(tuple({0: batch} for _ in inputs),))
    return Artifact(program, "logpdf", device)


def export_sampler(icnf, params: Dict[str, torch.Tensor], n: int, ys=None,
                   trace_free: bool = True, device=None) -> Artifact:
    """Export the sampling path, ``seed -> (n, nvariables)``, ``n`` fixed here.
    ``trace_free=True`` (default) integrates the bare field.  A conditional
    model bakes in ``ys`` (one condition row, or ``n`` of them).  The base
    distribution's sampler must trace: one that reads the device (a
    rejection loop) raises here."""
    _check_exportable(icnf, None, exact_trace=not trace_free)
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
            "the sampler reads the device while it draws (a data-dependent loop, e.g. "
            "a rejection sampler such as the Student-t base) and cannot be exported"
        ) from err
    return Artifact(program, "sampler", device)


def save_artifact(path: str, artifact: Artifact) -> None:
    """Write the program (``torch.export.save``) with its kind and device."""
    meta = json.dumps({"kind": artifact.kind, "device": str(artifact.device)})
    torch.export.save(artifact.program, path, extra_files={_META: meta})


def load_artifact(path: str) -> Artifact:
    """Load an artifact; ``.call(...)`` runs it (no model code needed)."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    return Artifact(program, meta["kind"], meta["device"])
