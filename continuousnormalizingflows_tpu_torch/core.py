"""Functional core: ``inference``, ``generate``, ``loss``.

Counterpart of ``continuousnormalizingflows_tpu.core``: each entry point pads
the state, draws the Hutchinson probe, steers the end time in regularized
train mode, runs the solve and splits the terminal state
``[z (nz), dlogp, E, n]``.  Where JAX takes a PRNG key, these take a
``torch.Generator``; every draw happens on the generator's device and moves
to the data's device, so one seed gives the same probe and end time whatever
route the solve then takes.

Draw order per call: ``inference`` steer then probe; ``generate*`` base,
steer, then probe (the trace-free path stops after steer, so the same seed
gives it the same base draw and end time as the full path).

``dt0`` (``inference``, ``loss``, ``loss_with_stats``): the carried starting
step of the adaptive solvers (``SolverConfig.dt0 == "carry"``), a 0-d
tensor such as the previous solve's ``abs(stats.dt_final)``.

Inside a sharded step (:func:`.parallel.mesh.use_mesh`) ``xs`` is this
rank's rows.  Every rank carries the same generator state, draws the
probes of the global batch (``data`` ranks x rows) and keeps its rows, and
with ``probe_axis`` its ``model`` rank's share of the ensemble; the steered
end time is one draw alike on every rank.  The result is one process's on
the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .config import LOG_2PI, ICNFConfig, Mode, ProbeDist
from .distributions import generator_arg
from .models.icnf import ICNF
from .models.nets import Params, _TorchNet
from .ops.adjoint import odeint_diff
from .ops.dynamics import (fused_dynamics_applicable, make_augmented_dynamics, make_field,
                           probe_share)
from .ops.fused_adaptive import (_scfg_tuple, fused_adaptive_applicable, fused_adaptive_tile,
                                  fused_solve_dopri5, stats_from_rows)
from .ops.fused_solve import fused_solve_applicable, fused_solve_rk4
from .ops.ode import SolverStats, eval_dense, odeint_dense, odeint_device
from .parallel import mesh as pmesh
from .utils import profiling

__all__ = [
    "base_logpdf",
    "sample_base",
    "sample_probe",
    "steer_t1",
    "inference",
    "block_terminal",
    "generate",
    "generate_with_logp",
    "loss",
    "loss_with_stats",
    "log_prob",
    "trajectory",
]


def _draw(fn, generator: torch.Generator, device) -> torch.Tensor:
    return fn(generator.device).to(device)


def base_logpdf(cfg: ICNFConfig, z: torch.Tensor) -> torch.Tensor:
    """Base log-density over the augmented dimension ``nz``: the config's
    ``base_dist``, or the standard normal (``base_dist=None``) in closed
    form."""
    if cfg.base_dist is not None:
        return cfg.base_dist.logpdf_fn(z)
    return -0.5 * (cfg.nz * LOG_2PI + torch.sum(torch.square(z), dim=-1))


def sample_base(cfg: ICNFConfig, generator: torch.Generator, n: int, device) -> torch.Tensor:
    """``(n, nz)`` base samples for the generate path."""
    if cfg.base_dist is not None:
        return cfg.base_dist.sample_fn(generator, (n, cfg.nz), cfg.dtype).to(device)
    return _draw(lambda d: torch.randn((n, cfg.nz), generator=generator_arg(generator),
                                       dtype=cfg.dtype, device=d), generator, device)


def sample_probe(cfg: ICNFConfig, generator: torch.Generator, batch: int,
                 device) -> torch.Tensor:
    """Fresh Hutchinson probes, ``(nprobes, batch, nz)``: Gaussian,
    Rademacher, or the config's custom ``probe_dist``."""
    shape = (cfg.nprobes, batch, cfg.nz)
    if not isinstance(cfg.probe_dist, ProbeDist):
        return cfg.probe_dist.sample_fn(generator, shape, cfg.dtype).to(device)
    if cfg.probe_dist is ProbeDist.RADEMACHER:
        fn = lambda d: 2.0 * torch.randint(0, 2, shape, generator=generator_arg(generator),
                                           device=d).to(cfg.dtype) - 1.0
    else:
        fn = lambda d: torch.randn(shape, generator=generator_arg(generator), dtype=cfg.dtype,
                                    device=d)
    return _draw(fn, generator, device)


def _shard_probe(cfg: ICNFConfig, generator: torch.Generator, batch: int,
                 device) -> torch.Tensor:
    """:func:`sample_probe` for ``batch`` rows, or inside a sharded step this
    rank's rows of the global batch's probes and its share of the ensemble."""
    ctx = pmesh.active()
    if ctx is None:
        return sample_probe(cfg, generator, batch, device)
    eps = sample_probe(cfg, generator, batch * ctx.data_size, device)
    lo, hi, _group = probe_share(cfg)
    r = ctx.data_rank
    return eps[lo:hi, r * batch:(r + 1) * batch]


def steer_t1(cfg: ICNFConfig, generator: torch.Generator, device) -> torch.Tensor:
    """STEER end time ``t1' = t1 + |t1 - t0| * r`` with ``r`` from the
    config's ``steer_dist``, or ``U(-rate, rate)`` (``steer_dist=None``), as a
    scalar tensor on ``device`` (no host synchronisation)."""
    t0, t1 = cfg.tspan
    if cfg.steer_dist is not None:
        r = cfg.steer_dist.sample_fn(generator, (), cfg.dtype).to(device)
    else:
        u = _draw(lambda d: torch.rand((), generator=generator_arg(generator), dtype=cfg.dtype,
                                       device=d),
                  generator, device)
        r = (2.0 * u - 1.0) * cfg.steer_rate
    return t1 + abs(t1 - t0) * r


def _solve(icnf: ICNF, mode: Mode, u0: torch.Tensor, t0, t1, params: Params,
           eps: Optional[torch.Tensor], ys: Optional[torch.Tensor],
           dt0: Optional[torch.Tensor] = None,
           device_loop: bool = False) -> Tuple[torch.Tensor, SolverStats]:
    """Solve the augmented state from ``t0`` to ``t1``.  The adaptive
    whole-solve route (K5, backward K6) is taken when
    :func:`fused_adaptive_applicable` and the batch makes whole control
    groups, then the fixed-step one (K3, backward K4) when
    :func:`fused_solve_applicable`; otherwise the dynamics (with the
    per-stage kernel K1 where it applies) go through :func:`odeint_diff`.
    ``dt0`` (the carried start) reaches only that last route: the kernels'
    controllers keep the fixed start, as in the JAX package.  ``device_loop``
    takes :func:`.ops.ode.odeint_device` (no host read, no gradient): the
    exported TEST surfaces, and only those.

    ``layout="feature_first"`` takes no fused route (the gates require
    ``batch_first``, as JAX's do): the unfused solve runs on ``u0``, ``eps``
    and ``ys`` transposed once here, and ``u1`` is transposed back.
    The unfused route's continuous adjoint replays ``icnf.graphs`` where
    :func:`_graphs` gives them."""
    cfg = icnf.config
    if device_loop:
        if mode.stochastic:
            raise ValueError(f"device_loop=True serves only Mode.TEST (the exported "
                             f"surfaces), not {mode}: the training modes take the kernels "
                             f"or the differentiable solve")
        profiling.count("solve.device_loop")
        with profiling.span("solve", route="device_loop"):
            f_aug = make_augmented_dynamics(cfg, icnf.net, mode, device_loop=True)
            u0, args = _layout_in(cfg, u0, {"params": params, "eps": eps, "ys": ys})
            with torch.no_grad():
                u1, stats = odeint_device(f_aug, u0, t0, t1, args, cfg.solver)
            return _layout_out(cfg, u1), stats
    if (eps is not None and fused_adaptive_applicable(cfg, icnf.net, mode)
            and fused_adaptive_tile(u0.shape[0], whole_groups=_split_rows())):
        profiling.count("solve.fused_adaptive")
        with profiling.span("solve", route="fused_adaptive"):
            t_col = None if cfg.autonomous else cfg.nz
            # the node buffer is device memory: dense_max_nodes is honored as given
            # the kernels take the whole net: a tensor-parallel one's slices gathered
            u1, rows = fused_solve_dopri5(u0, eps[0], ys, pmesh.whole_mlp_params(params),
                                          (t0, t1), cfg.nz, t_col,
                                          _scfg_tuple(cfg.solver), cfg.solver.dense_max_nodes)
            return u1, stats_from_rows(rows, cfg.dtype)
    if eps is not None and fused_solve_applicable(cfg, icnf.net, mode):
        profiling.count("solve.fused_rk4")
        with profiling.span("solve", route="fused_rk4"):
            steps = cfg.solver.fixed_steps
            cdt = torch.bfloat16 if icnf.net.precision != "highest" else None
            t_col = None if cfg.autonomous else cfg.nz
            u1 = fused_solve_rk4(u0, eps[0], ys, pmesh.whole_mlp_params(params), (t0, t1),
                                 cfg.nz, t_col, steps, cdt)
            with profiling.host_read("solve.stats"):  # a float end: a synchronizing copy
                dt = (torch.as_tensor(t1, dtype=cfg.dtype, device=u0.device)
                      - torch.as_tensor(t0, dtype=cfg.dtype, device=u0.device)) / steps
            return u1, SolverStats(4 * steps, steps, 0, dt)
    profiling.count("solve.unfused")
    with profiling.span("solve", route="unfused"):
        f_aug = make_augmented_dynamics(cfg, icnf.net, mode)
        u0, args = _layout_in(cfg, u0, {"params": params, "eps": eps, "ys": ys})
        if dt0 is not None:
            args["dt0"] = dt0
        u1, stats = odeint_diff(f_aug, u0, t0, t1, args, cfg.solver, _graphs(icnf, mode))
        return _layout_out(cfg, u1), stats


def _graphs(icnf: ICNF, mode: Mode) -> Optional[dict]:
    """``icnf``'s cache of CUDA graphs of its solves in ``mode``
    (:func:`.ops.adjoint.odeint_diff`), or None where its dynamics are not
    the port's own operations alone: the fused stage's kernels (K1, K2)
    count their launches on the host, and a ``from_torch`` module's code
    may read the device from the host."""
    if fused_dynamics_applicable(icnf.config, icnf.net, mode) or isinstance(icnf.net, _TorchNet):
        return None
    return icnf.graphs.setdefault(mode, {})


def _layout_in(cfg: ICNFConfig, u0: torch.Tensor, args: dict):
    """The solve's state and args in the config's layout: feature-first
    transposes ``u0`` to ``(state_dim, B)``, the probes to ``(P, nz, B)`` and
    the conditions to ``(nc, B)``, each made contiguous (the batch the
    minor axis)."""
    if cfg.layout != "feature_first":
        return u0, args
    eps, ys = args["eps"], args["ys"]
    return u0.t().contiguous(), dict(
        args, eps=None if eps is None else eps.transpose(1, 2).contiguous(),
        ys=None if ys is None else ys.t().contiguous())


def _layout_out(cfg: ICNFConfig, u1: torch.Tensor) -> torch.Tensor:
    return u1.t() if cfg.layout == "feature_first" else u1


def _split_rows() -> bool:
    """Whether a sharded step splits the batch's rows over several ranks."""
    ctx = pmesh.active()
    return ctx is not None and ctx.data_size > 1


def _split_terminal(cfg: ICNFConfig, mode: Mode, u1: torch.Tensor):
    nz = cfg.nz
    z = u1[..., :nz]
    dlogp = u1[..., nz]
    e_acc = u1[..., nz + 1]
    n_acc = u1[..., nz + 2]
    logpx = base_logpdf(cfg, z) - dlogp
    if cfg.augmented and cfg.norm_z_aug and mode is Mode.TRAIN:
        a_term = torch.sqrt(torch.sum(torch.square(z[..., cfg.nvariables:]), dim=-1))
    else:
        a_term = torch.zeros_like(dlogp)
    return logpx, (e_acc, n_acc, a_term)


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


def _as_batch(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    return (x[None, :], True) if x.ndim == 1 else (x, False)


def _prep_ys(cfg: ICNFConfig, ys, device) -> Optional[torch.Tensor]:
    if ys is None:
        return None
    return _as_batch(torch.as_tensor(ys, dtype=cfg.dtype, device=device))[0]


def _need_generator(mode: Mode, generator: Optional[torch.Generator]) -> None:
    if generator is None and mode.stochastic:
        raise ValueError("train mode needs a torch.Generator (probe + steer sampling)")


def _forward_solve(icnf: ICNF, mode: Mode, xs, params: Params,
                   generator: Optional[torch.Generator], ys, dt0: Optional[torch.Tensor],
                   device_loop: bool, tspan=None):
    """``(u1, stats, single)``: the padded state of ``xs`` solved over the
    span (``tspan``, default the config's), the end time steered and the
    probes drawn as ``mode`` asks."""
    cfg = icnf.config
    device = _device_of(params)
    xs, single = _as_batch(torch.as_tensor(xs, dtype=cfg.dtype, device=device))
    ys = _prep_ys(cfg, ys, device)
    _need_generator(mode, generator)
    batch = xs.shape[0]
    u0 = torch.cat(
        [xs, torch.zeros((batch, cfg.n_aug_input + 3), dtype=cfg.dtype, device=device)], dim=-1
    )
    t0, t1 = cfg.tspan if tspan is None else tspan
    if mode.regularized and cfg.steered:
        t1 = steer_t1(cfg, generator, device)
    eps = _shard_probe(cfg, generator, batch, device) if mode.stochastic else None
    u1, stats = _solve(icnf, mode, u0, t0, t1, params, eps, ys, dt0, device_loop)
    return u1, stats, single


def inference(icnf: ICNF, mode: Mode, xs, params: Params,
              generator: Optional[torch.Generator] = None, ys=None,
              dt0: Optional[torch.Tensor] = None, device_loop: bool = False):
    """Forward solve x -> z; returns ``(logpx, (E, n, A), SolverStats)``.

    ``xs``: ``(batch, nvariables)`` or one ``(nvariables,)`` sample.
    ``device_loop=True``: the solve's control stays on the device (what
    ``torch.export`` captures; no gradient, and the counts in the stats are
    0-d tensors), with the same steps as the default loop."""
    cfg = icnf.config
    u1, stats, single = _forward_solve(icnf, mode, xs, params, generator, ys, dt0, device_loop)
    logpx, augs = _split_terminal(cfg, mode, u1)
    if single:
        logpx, augs = logpx[0], tuple(a[0] for a in augs)
    return logpx, augs, stats


def block_terminal(icnf: ICNF, mode: Mode, xs: torch.Tensor, params: Params,
                   generator: Optional[torch.Generator] = None, tspan=None):
    """One block of a chain of flows (:class:`.models.multiscale.MultiscaleICNF`):
    the solve of :func:`inference` from the rows ``xs`` ``(batch, nz)``,
    returned as the terminal state's columns ``(z1 (batch, nz), dlogp, E, n,
    SolverStats)``, which the chain sums over its blocks.  ``logpx`` of one
    block alone would be ``base_logpdf(z1) - dlogp``.  ``tspan``: the
    span's ends as 0-d tensors on the rows' device (no copy from the host,
    so no wait for the stream), or None for the config's."""
    nz = icnf.config.nz
    u1, stats, _single = _forward_solve(icnf, mode, xs, params, generator, None, None, False,
                                        tspan)
    return u1[:, :nz], u1[:, nz], u1[:, nz + 1], u1[:, nz + 2], stats


def generate_with_logp(icnf: ICNF, mode: Mode, params: Params, generator: torch.Generator,
                       n: int, ys=None,
                       device_loop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(samples (n, nvariables), logpx (n,))`` from ONE reversed solve: the
    backward integration accumulates ``-dlogp``, so
    ``logp(x) = logpdf_base(z1) + u[nz]``.  ``device_loop``: as in
    :func:`inference`."""
    cfg = icnf.config
    device = _device_of(params)
    ys = _prep_ys(cfg, ys, device)
    z1 = sample_base(cfg, generator, n, device)
    t0, t1 = cfg.tspan
    if mode.regularized and cfg.steered:
        t1 = steer_t1(cfg, generator, device)
    eps = sample_probe(cfg, generator, n, device) if mode.stochastic else None
    u0 = torch.cat([z1, torch.zeros((n, 3), dtype=cfg.dtype, device=device)], dim=-1)
    u_final, _stats = _solve(icnf, mode, u0, t1, t0, params, eps, ys, None, device_loop)
    logpx = base_logpdf(cfg, z1) + u_final[..., cfg.nz]
    return u_final[..., : cfg.nvariables], logpx


def _generate_tracefree(icnf: ICNF, mode: Mode, params: Params, generator: torch.Generator,
                        n: int, ys, device_loop: bool = False) -> torch.Tensor:
    """Integrates the bare field ``dz/dt = f(z, t)`` backward: the flow map
    does not depend on the accumulators, so sampling skips the trace."""
    cfg = icnf.config
    device = _device_of(params)
    z1 = sample_base(cfg, generator, n, device)
    t0, t1 = cfg.tspan
    if mode.regularized and cfg.steered:
        t1 = steer_t1(cfg, generator, device)
    field = make_field(cfg, icnf.net)
    f = lambda t, z, args: field(t, z, args["params"], args["ys"])
    if device_loop:
        with torch.no_grad():
            z0, _stats = odeint_device(f, z1, t1, t0, {"params": params, "ys": ys}, cfg.solver)
        return z0[..., : cfg.nvariables]
    solver = cfg.solver
    if solver.gradient == "quadrature":
        # the z-only state needs no interpolant: backsolve is exact for sampling
        solver = dataclasses.replace(solver, gradient="adjoint")
    z0, _stats = odeint_diff(f, z1, t1, t0, {"params": params, "ys": ys}, solver)
    return z0[..., : cfg.nvariables]


def generate(icnf: ICNF, mode: Mode, params: Params, generator: torch.Generator, n: int,
             ys=None, trace_free: bool = False, device_loop: bool = False) -> torch.Tensor:
    """Sample ``n`` points by integrating the flow backward t1 -> t0.
    ``trace_free=True`` integrates the bare field (same distribution, no
    per-step trace estimate).  ``device_loop``: as in :func:`inference`."""
    ys = _prep_ys(icnf.config, ys, _device_of(params))
    if trace_free:
        return _generate_tracefree(icnf, mode, params, generator, int(n), ys, device_loop)
    return generate_with_logp(icnf, mode, params, generator, int(n), ys, device_loop)[0]


def loss_with_stats(icnf: ICNF, mode: Mode, xs, params: Params,
                    generator: Optional[torch.Generator] = None, ys=None,
                    dt0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SolverStats]:
    """``(mean(-logpx + l1*E + l2*n + l3*A), solver stats)``."""
    cfg = icnf.config
    logpx, (e_acc, n_acc, a_term), stats = inference(icnf, mode, xs, params, generator, ys,
                                                     dt0)
    l = torch.mean(
        -logpx + cfg.lambda_1 * e_acc + cfg.lambda_2 * n_acc + cfg.lambda_3 * a_term
    )
    return l, stats


def loss(icnf: ICNF, mode: Mode, xs, params: Params,
         generator: Optional[torch.Generator] = None, ys=None,
         dt0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Regularized negative log-likelihood ``mean(-logpx + l1*E + l2*n + l3*A)``."""
    return loss_with_stats(icnf, mode, xs, params, generator, ys, dt0)[0]


def log_prob(icnf: ICNF, mode: Mode, xs, params: Params,
             generator: Optional[torch.Generator] = None, ys=None,
             device_loop: bool = False) -> torch.Tensor:
    """Just ``logpx``.  ``device_loop``: as in :func:`inference`."""
    return inference(icnf, mode, xs, params, generator, ys, device_loop=device_loop)[0]


def trajectory(icnf: ICNF, xs, params: Params, ts, ys=None):
    """The flow ``z(t)`` at the times ``ts`` (clamped to ``tspan``), read off
    the dense output of one TEST-mode (exact trace) adaptive solve; a
    fixed-step config solves with dopri5 for it, and a feature-first one
    batch-first.  Returns ``(path (len(ts), batch, nz), SolverStats)``."""
    cfg = icnf.config
    device = _device_of(params)
    xs, _single = _as_batch(torch.as_tensor(xs, dtype=cfg.dtype, device=device))
    ys = _prep_ys(cfg, ys, device)
    batch = xs.shape[0]
    u0 = torch.cat(
        [xs, torch.zeros((batch, cfg.n_aug_input + 3), dtype=cfg.dtype, device=device)], dim=-1
    )
    solver = cfg.solver
    if solver.method not in ("dopri5", "tsit5", "abm"):
        solver = dataclasses.replace(solver, method="dopri5", gradient="adjoint")
    # the state here is batch-first: the batch-first dynamics whatever the
    # layout (JAX's trajectory forces it too)
    if cfg.layout != "batch_first":
        cfg = dataclasses.replace(cfg, layout="batch_first")
    f_aug = make_augmented_dynamics(cfg, icnf.net, Mode.TEST)
    t0, t1 = cfg.tspan
    ts = torch.as_tensor(ts, dtype=cfg.dtype, device=device).reshape(-1)
    with torch.no_grad():
        _u1, stats, dense = odeint_dense(f_aug, u0, t0, t1,
                                         {"params": params, "eps": None, "ys": ys}, solver)
        path = torch.stack([eval_dense(dense, t) for t in ts])
    return path[..., : cfg.nz], stats
