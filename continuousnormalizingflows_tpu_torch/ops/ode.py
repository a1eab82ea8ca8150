"""ODE integrators over tensors and tuples of tensors.

Counterpart of ``continuousnormalizingflows_tpu.ops.ode``:
``odeint(f, y0, t0, t1, args, cfg) -> (y1, SolverStats)`` with
``f(t, y, args) -> dy``, where ``y`` is a tensor or a tuple of tensors (the
adjoint's backward state ``(y, a, q...)`` is a tuple).

* ``rk4`` / ``euler``: fixed steps, a Python loop in place of ``lax.scan``.
* ``dopri5`` / ``tsit5``: embedded Runge-Kutta 5(4) with FSAL and the JAX
  package's controller, error norm and failure policy.  The ``lax.while_loop``
  becomes a Python loop whose ``t``, ``dt``, ``accept``, ``done`` and ``fail``
  are device tensors (a steered end time is a device scalar); the loop reads
  ``done | fail`` and ``accept`` back to the host once per trial step, in one
  transfer.  The error norm is one RMS over every element of the batch, as in
  the reference: the whole batch takes one step sequence.  Inside a sharded
  step (:func:`..parallel.mesh.use_mesh`) each norm all-reduces its sum of
  squares and its count over the mesh in one collective before the host
  reads it, so every rank takes one process's steps on the whole batch.
  :func:`odeint_device` is the same loop with its control on the device
  (``while_loop``, accept and reject by ``torch.where``), for export.
* ``abm``: variable-step, variable-order Adams-Bashforth-Moulton PECE (the
  reference's VCABM class), two evaluations a trial step, the order moved
  among ``{k-1, k, k+1}`` by their Milne error estimates.  The order is a
  0-d device tensor that picks each candidate's weights from the tables of
  every order (JAX's ``lax.switch``); the eager loop reads accept, ``done``
  and ``fail`` back in one transfer a trial step, and
  :func:`odeint_device` runs the same trial step in a ``while_loop``.
* dense output (``odeint_dense``, ``eval_dense``): the accepted nodes with
  their FSAL (``abm``: PECE second-evaluate) derivatives, interpolated by
  cubic Hermite.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ABM_MAX_ORDER, DEFAULT_FIXED_DT0, SolverConfig
from ..parallel.mesh import global_mean
from ..utils import profiling

__all__ = ["odeint", "odeint_fixed", "odeint_dopri5", "odeint_abm", "odeint_dopri5_dense",
           "odeint_abm_dense", "odeint_dense", "odeint_device", "eval_dense", "DenseSolution",
           "SolverStats", "DOPRI5", "TSIT5"]

State = Any  # a tensor or a tuple of tensors
ODEFunc = Callable[[Any, State, Any], State]

# ``error_weight`` entries besides True (in the norm; under a sharded step a
# leaf whose rows are split over the ranks) and False (out of it): in the
# norm, and alike on every rank, so counted once (the adjoint's parameter
# leaves once their VJP is summed over the ranks)
SHARED = "shared"
# in the norm, alike over ``data`` and sliced over ``model``: a
# tensor-parallel MLP's split parameter leaves, counted once a slice
SPLIT = "split"


def _norm_parts():
    """Running ``[sum of squares, count]`` by ``error_weight`` entry."""
    return {True: [0.0, 0], SHARED: [0.0, 0], SPLIT: [0.0, 0]}


def _parts_mean(parts) -> torch.Tensor:
    """:func:`global_mean` of :func:`_norm_parts` (the split part's
    arguments only where there is one)."""
    (total, count), shared, (t_split, n_split) = parts[True], parts[SHARED], parts[SPLIT]
    split = {"total_split": t_split, "count_split": n_split} if n_split else {}
    return global_mean(total, count, *shared, **split)


class SolverStats(NamedTuple):
    """Per-solve diagnostics; ``int(stats)`` is the NFE.  Fixed-step methods
    report ``naccept = steps, nreject = 0``.  The counts are ints, or 0-d
    device tensors where reading them would cost a host synchronisation (the
    whole-solve adaptive kernel's)."""

    nfe: Any
    naccept: Any
    nreject: Any
    dt_final: torch.Tensor  # signed step size at exit

    def __int__(self) -> int:
        return int(self.nfe)


# ---- tuple-state helpers (the JAX package's tree maps) ----

def _leaves(y: State) -> Tuple[torch.Tensor, ...]:
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def _like(y0: State, leaves) -> State:
    return tuple(leaves) if isinstance(y0, (tuple, list)) else leaves[0]


def _add_scaled(y: State, dt, terms) -> State:
    """``y + sum_i (dt * c_i) * k_i``, skipping zero coefficients."""
    terms = [(c, k) for c, k in terms if c != 0.0]
    out = []
    for i, leaf in enumerate(_leaves(y)):
        acc = leaf
        for c, k in terms:
            acc = acc + dt * c * _leaves(k)[i]
        out.append(acc)
    return _like(y, out)


def _scaled_sum(dt, terms) -> State:
    terms = [(c, k) for c, k in terms if c != 0.0]
    ref = terms[0][1]
    out = []
    for i in range(len(_leaves(ref))):
        acc = dt * terms[0][0] * _leaves(terms[0][1])[i]
        for c, k in terms[1:]:
            acc = acc + dt * c * _leaves(k)[i]
        out.append(acc)
    return _like(ref, out)


# ---- fixed-step methods ----

def _rk4_step(f: ODEFunc, t, y: State, dt, args) -> State:
    k1 = f(t, y, args)
    k2 = f(t + 0.5 * dt, _add_scaled(y, dt, [(0.5, k1)]), args)
    k3 = f(t + 0.5 * dt, _add_scaled(y, dt, [(0.5, k2)]), args)
    k4 = f(t + dt, _add_scaled(y, dt, [(1.0, k3)]), args)
    return _add_scaled(y, dt, [(1 / 6, k1), (1 / 3, k2), (1 / 3, k3), (1 / 6, k4)])


def _euler_step(f: ODEFunc, t, y: State, dt, args) -> State:
    return _add_scaled(y, dt, [(1.0, f(t, y, args))])


def _pop_dt0(args):
    """Split the carried starting step (``args["dt0"]``, ``SolverConfig.dt0 ==
    "carry"``) out of a dict ``args``: ``(args_without_dt0, dt0_or_None)``."""
    if isinstance(args, dict) and "dt0" in args:
        args = dict(args)
        return args, args.pop("dt0")
    return args, None


def _time_dtype(y0: State) -> torch.dtype:
    dt = _leaves(y0)[0].dtype
    return dt if dt.is_floating_point else torch.float32


def _times(y0: State, t0, t1):
    leaf = _leaves(y0)[0]
    tdt = _time_dtype(y0)
    return (torch.as_tensor(t0, dtype=tdt, device=leaf.device),
            torch.as_tensor(t1, dtype=tdt, device=leaf.device), tdt)


def odeint_fixed(f: ODEFunc, y0: State, t0, t1, args,
                 cfg: SolverConfig) -> Tuple[State, SolverStats]:
    """``cfg.fixed_steps`` steps of rk4 or euler.  With ``cfg.remat`` and grad
    enabled each step runs under ``torch.utils.checkpoint`` (non-reentrant):
    the backward keeps only each step's input and recomputes the step's
    stages, as ``jax.checkpoint`` of the scan body does in the JAX package.
    That changes the backward's memory, not the values."""
    t0, t1, _tdt = _times(y0, t0, t1)
    args, _dt0 = _pop_dt0(args)  # fixed steps: no starting-step choice
    n = int(cfg.fixed_steps)
    dt = (t1 - t0) / n
    step = {"rk4": _rk4_step, "euler": _euler_step}[cfg.method]
    evals = {"rk4": 4, "euler": 1}[cfg.method]
    remat = cfg.remat and torch.is_grad_enabled()
    y = y0
    for i in range(n):
        if remat:
            y = checkpoint(step, f, t0 + i * dt, y, dt, args, use_reentrant=False)
        else:
            y = step(f, t0 + i * dt, y, dt, args)
    return y, SolverStats(evals * n, n, 0, dt)


# ---- embedded Runge-Kutta 5(4) ----

class _Tableau(NamedTuple):
    name: str
    C: tuple
    A: tuple  # rows 1..s-1; the final combination is B
    B: tuple  # solution weights (== the FSAL stage's row)
    BERR: tuple  # B - B_hat over the s + 1 stages (FSAL stage included)
    order: int


_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
DOPRI5 = _Tableau(
    name="dopri5",
    C=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0),
    A=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    ),
    B=_DP_B,
    BERR=tuple(b - b4 for b, b4 in zip(_DP_B + (0.0,), _DP_B4)),
    order=5,
)

TSIT5 = _Tableau(
    name="tsit5",
    C=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0),
    A=(
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
         -0.028269050394068383),
    ),
    B=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774),
    BERR=(-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
          -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
          0.015151515151515152),
    order=5,
)

_TABLEAUS = {"dopri5": DOPRI5, "tsit5": TSIT5}

# give-up threshold: a non-finite trial at |dt| below this fraction of the
# span means the field itself is non-finite; exit and NaN-poison
_DT_GIVE_UP = 1e-6


def _erk_step(tab: _Tableau, f: ODEFunc, t, y: State, dt, k1: State, args):
    """One embedded trial step from ``k1 = f(t, y)`` (FSAL): ``(y_new, err,
    k_last)`` with ``k_last = f(t + dt, y_new)``."""
    ks = [k1]
    for i, row in enumerate(tab.A):
        yi = _add_scaled(y, dt, zip(row, ks))
        ks.append(f(t + tab.C[i + 1] * dt, yi, args))
    y_new = _add_scaled(y, dt, zip(tab.B, ks))
    k_last = f(t + dt, y_new, args)
    ks.append(k_last)
    err = _scaled_sum(dt, zip(tab.BERR, ks))
    return y_new, err, k_last


def _rms_error_ratio(err: State, y0: State, y1: State, rtol: float, atol: float,
                     error_weight=None) -> torch.Tensor:
    """RMS of ``err / (atol + rtol * max(|y0|, |y1|))`` over every element of
    the leaves that ``error_weight`` marks (all when None; :data:`SHARED`
    leaves once over the ranks, :data:`SPLIT` ones once a slice): one scalar
    for the whole batch.  Leaving a leaf out is the seminorm of the
    adjoint's parameter quadrature."""
    leaves = zip(_leaves(err), _leaves(y0), _leaves(y1))
    weights = _leaves(error_weight) if error_weight is not None else None
    parts = _norm_parts()
    for i, (e, a, b) in enumerate(leaves):
        w = True if weights is None else weights[i]
        if not w:
            continue
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        r = (e / scale).to(torch.float32)
        part = parts[w]
        part[0] = part[0] + torch.sum(r * r)
        part[1] += r.numel()
    return torch.sqrt(_parts_mean(parts))


def _controller_factor(ratio, inv_order, safety, min_factor, max_factor, tdt):
    """Non-finite-safe step factor: a NaN/Inf ratio is a hard reject with the
    smallest factor.  Returns ``(finite, factor)``."""
    finite = torch.isfinite(ratio)
    safe = torch.where(finite, torch.clamp(ratio, min=1e-10), torch.ones_like(ratio))
    factor = torch.clamp(safety * torch.pow(safe, -inv_order), min_factor, max_factor)
    return finite, torch.where(finite, factor, torch.full_like(factor, min_factor)).to(tdt)


def _wnorm(x: State, yref: State, cfg: SolverConfig) -> torch.Tensor:
    s, c = 0.0, 0
    for xe, ye in zip(_leaves(x), _leaves(yref)):
        r = (xe / (cfg.atol + cfg.rtol * torch.abs(ye))).to(torch.float32)
        s = s + torch.sum(r * r)
        c += r.numel()
    return torch.sqrt(global_mean(s, c))


def _initial_dt(f, t0, y0, f0, args, cfg, span, direction, err_order, tdt, override=None):
    """Starting step: ``(dt_init, extra_nfe)``.  A carried ``override`` wins
    (a non-finite or non-positive one falls back to the fixed fraction of the
    span); a float ``cfg.dt0`` is that fraction of the span; ``"auto"`` is the
    Hairer-Norsett-Wanner algorithm (one extra evaluation)."""
    if override is not None:
        raw = torch.abs(torch.as_tensor(override, dtype=tdt, device=span.device))
        ok = torch.isfinite(raw) & (raw > 0)
        dt = torch.where(ok, torch.minimum(raw, torch.abs(span)), DEFAULT_FIXED_DT0 * torch.abs(span))
        return direction * dt, 0
    if not isinstance(cfg.dt0, str):
        return span * torch.as_tensor(float(cfg.dt0), dtype=tdt), 0
    with profiling.host_read("ode.start"):  # a copy from pageable memory: waits for the stream
        tiny = torch.tensor(1e-6, dtype=tdt, device=span.device)
    d0 = _wnorm(y0, y0, cfg)
    d1 = _wnorm(f0, y0, cfg)
    h0 = torch.where(torch.minimum(d0, d1) < 1e-5, tiny,
                     0.01 * d0 / torch.clamp(d1, min=1e-12)).to(tdt)
    h0 = torch.minimum(h0, torch.abs(span))
    y1 = _like(y0, [a + direction * h0 * b for a, b in zip(_leaves(y0), _leaves(f0))])
    f1 = f(t0 + direction * h0, y1, args)
    d2 = _wnorm(_like(f0, [a - b for a, b in zip(_leaves(f1), _leaves(f0))]), y0, cfg) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.maximum(tiny, h0 * 1e-3),
        torch.pow(torch.clamp(0.01 / torch.clamp(dmax, min=1e-12), min=1e-12), 1.0 / err_order),
    ).to(tdt)
    dt = torch.minimum(torch.minimum(100.0 * h0, h1), torch.abs(span))
    dt = torch.where(torch.isfinite(dt), dt, DEFAULT_FIXED_DT0 * torch.abs(span))
    return direction * dt, 1


class _Loop(NamedTuple):
    """What one adaptive solve ends with."""

    y: State
    dt: torch.Tensor
    nfe: int
    steps: int
    nacc: int
    done: bool


class _Control(NamedTuple):
    """What a trial step's decision needs besides its state (fixed over a
    solve)."""

    tab: object
    cfg: SolverConfig
    error_weight: object
    t1: torch.Tensor
    direction: torch.Tensor
    tol_done: torch.Tensor
    give_up: torch.Tensor
    tdt: torch.dtype


def _start(f, y0, t0, t1, args, cfg, error_weight, dt0_override):
    """The adaptive solve's set-up, shared by the eager and the device loop:
    ``(ctl, t0, k1, dt, nfe)``, the FSAL derivative at ``t0`` and the first
    step (``nfe``: the evaluations so far)."""
    tab = _TABLEAUS.get(cfg.method, DOPRI5)
    t0, t1, tdt = _times(y0, t0, t1)
    span = t1 - t0
    direction = torch.sign(span)
    ctl = _Control(tab, cfg, error_weight, t1, direction,
                   1e-12 * torch.clamp(torch.abs(t1), min=1.0), _DT_GIVE_UP * torch.abs(span),
                   tdt)
    k1 = f(t0, y0, args)
    dt, nfe_init = _initial_dt(f, t0, y0, k1, args, cfg, span, direction, tab.order + 1, tdt,
                               dt0_override)
    return ctl, t0, k1, dt, 1 + nfe_init


def _land(ctl, t_new):
    """``t_new``, or ``t1`` where it lies past ``t1``.  The step clamped to
    ``t1 - t`` lands on ``t1`` up to the rounding of ``t + (t1 - t)``, which in
    float32 falls past ``t1`` for about one last step in seven that starts
    below ``t1 / 2``.  Past ``t1``, the done test (within 1e-12) never holds
    and each next step, ``direction * |t1 - t|``, moves away from ``t1``: the
    solve runs off (the JAX package's loop, ``ops/ode.py`` :404-420, does
    so).  Every step sequence that does not overshoot is unchanged."""
    return torch.where(ctl.direction * (ctl.t1 - t_new) < 0, ctl.t1, t_new)


def _trial(ctl: _Control, f, t, dt, y, k1, args):
    """One trial step and its decision, shared by the eager and the device
    loop so that both take the same steps: ``(y5, k7, t_new, dt_new,
    accept, done, fail)``, the flags as 0-d bool tensors (``fail``: a
    non-finite field at a step below the give-up size)."""
    cfg = ctl.cfg
    dt_c = ctl.direction * torch.minimum(torch.abs(dt), torch.abs(ctl.t1 - t))
    y5, err, k7 = _erk_step(ctl.tab, f, t, y, dt_c, k1, args)
    ratio = _rms_error_ratio(err, y, y5, cfg.rtol, cfg.atol, ctl.error_weight)
    finite, factor = _controller_factor(ratio, 1.0 / ctl.tab.order, cfg.safety,
                                        cfg.min_factor, cfg.max_factor, ctl.tdt)
    accept = finite & (ratio <= 1.0)
    t_new = _land(ctl, torch.where(accept, t + dt_c, t))
    done = accept & (torch.abs(ctl.t1 - t_new) <= ctl.tol_done)
    fail = ~finite & (torch.abs(dt_c) <= ctl.give_up)
    return y5, k7, t_new, dt_c * factor, accept, done, fail


def _adaptive_loop(f, y0, t0, t1, args, cfg, error_weight, dt0_override, on_accept=None):
    """The embedded-RK loop shared by :func:`odeint_dopri5` and its dense
    form.  ``on_accept(t_new, y_new, k_new)`` sees every accepted step."""
    ctl, t0, k1, dt, nfe = _start(f, y0, t0, t1, args, cfg, error_weight, dt0_override)
    n_evals = len(ctl.tab.A) + 1  # new evaluations per trial step (FSAL)
    t, y = t0, y0
    steps, nacc, done = 0, 0, False
    if on_accept is not None:
        on_accept(t0, y0, k1)
    while steps < cfg.max_steps:
        with profiling.span("ode.trial"):
            y5, k7, t, dt, accept, done_t, fail_t = _trial(ctl, f, t, dt, y, k1, args)
            flags = torch.stack([done_t | fail_t, accept, done_t])
            # the one host read of the trial step
            with profiling.host_read("ode.trial"):
                stop, acc, done = flags.tolist()
        nfe, steps = nfe + n_evals, steps + 1
        if acc:
            nacc += 1
            y, k1 = y5, k7
            if on_accept is not None:
                on_accept(t, y, k1)
        if stop:
            break
    return _Loop(y, dt, nfe, steps, nacc, done)


def _poison(y: State, ok: bool) -> State:
    return y if ok else _like(y, [torch.full_like(l, float("nan")) for l in _leaves(y)])


def _adaptive_device_loop(f, y0, t0, t1, args, cfg) -> Tuple[State, SolverStats]:
    """:func:`_adaptive_loop` with its control on the device: one
    ``while_loop`` whose carry holds ``t``, ``dt``, the step counts, the
    done/fail flags, ``y`` and the FSAL derivative, accept and reject by
    ``torch.where`` and the poison as a ``where``; no host read, so
    ``torch.export`` captures it.  The set-up and the trial step are the
    eager loop's (:func:`_start`, :func:`_trial`), so both take the same
    steps."""
    from torch._higher_order_ops.while_loop import while_loop

    args, dt0_override = _pop_dt0(args)
    ctl, t0, k1, dt, nfe_init = _start(f, y0, t0, t1, args, cfg, None, dt0_override)
    n_evals = len(ctl.tab.A) + 1
    n_y = len(_leaves(y0))
    count = lambda: torch.zeros((), dtype=torch.int64, device=t0.device)
    flag = lambda: torch.zeros((), dtype=torch.bool, device=t0.device)

    def cond(t, dt, steps, nacc, done, fail, *yk):
        return ~(done | fail) & (steps < cfg.max_steps)

    def body(t, dt, steps, nacc, done, fail, *yk):
        y, k1 = _like(y0, yk[:n_y]), _like(y0, yk[n_y:])
        y5, k7, t_new, dt_new, accept, done, fail = _trial(ctl, f, t, dt, y, k1, args)
        keep = [torch.where(accept, new, old)
                for new, old in zip(_leaves(y5) + _leaves(k7), yk)]
        return (t_new, dt_new, steps + 1, nacc + accept.to(torch.int64), done, fail, *keep)

    _t, dt, steps, nacc, done, _fail, *yk = while_loop(
        cond, body, (t0, dt, count(), count(), flag(), flag(), *_leaves(y0), *_leaves(k1)))
    y = _like(y0, [torch.where(done, l, torch.full_like(l, float("nan"))) for l in yk[:n_y]])
    return y, SolverStats(nfe_init + n_evals * steps, nacc, steps - nacc, dt)


def _fixed_device_loop(f, y0, t0, t1, args, cfg) -> Tuple[State, SolverStats]:
    """:func:`odeint_fixed` as one ``while_loop`` over its steps (the same
    step function at the same times, so the same bits): ``torch.export``
    traces one step instead of ``fixed_steps`` of them."""
    from torch._higher_order_ops.while_loop import while_loop

    t0, t1, _tdt = _times(y0, t0, t1)
    args, _dt0 = _pop_dt0(args)
    n = int(cfg.fixed_steps)
    dt = (t1 - t0) / n
    step = {"rk4": _rk4_step, "euler": _euler_step}[cfg.method]
    evals = {"rk4": 4, "euler": 1}[cfg.method]

    def body(i, *y):
        return (i + 1, *_leaves(step(f, t0 + i * dt, _like(y0, list(y)), dt, args)))

    _i, *y = while_loop(lambda i, *y: i < n, body,
                        (torch.zeros((), dtype=torch.int64, device=t0.device), *_leaves(y0)))
    return _like(y0, y), SolverStats(evals * n, n, 0, dt)


def odeint_device(f: ODEFunc, y0: State, t0, t1, args,
                  cfg: SolverConfig) -> Tuple[State, SolverStats]:
    """A forward solve with no host read, for ``torch.export``: dopri5/tsit5
    by :func:`_adaptive_device_loop`, abm by :func:`_abm_device_loop` (the
    counts in their stats are 0-d tensors) and fixed steps by
    :func:`_fixed_device_loop`.  Not differentiable: call it under
    ``torch.no_grad``."""
    if cfg.method in _TABLEAUS:
        return _adaptive_device_loop(f, y0, t0, t1, args, cfg)
    if cfg.method == "abm":
        args, _ignored = _pop_dt0(args)
        return _abm_device_loop(f, y0, t0, t1, args, cfg)
    return _fixed_device_loop(f, y0, t0, t1, args, cfg)


def odeint_dopri5(f: ODEFunc, y0: State, t0, t1, args, cfg: SolverConfig, error_weight=None,
                  dt0_override=None) -> Tuple[State, SolverStats]:
    """Adaptive embedded Runge-Kutta (the tableau from ``cfg.method``).  The
    result is NaN-poisoned when the step budget runs out or the field is
    non-finite (never a silently truncated solve).  Not differentiable by
    autograd: wrap it with :func:`.adjoint.odeint_diff`."""
    args, popped = _pop_dt0(args)
    if dt0_override is None:
        dt0_override = popped
    run = _adaptive_loop(f, y0, t0, t1, args, cfg, error_weight, dt0_override)
    return _poison(run.y, run.done), SolverStats(run.nfe, run.nacc, run.steps - run.nacc, run.dt)


# ---- dense output ----

class DenseSolution(NamedTuple):
    """Piecewise cubic Hermite interpolant of an adaptive solve over its
    accepted nodes ``(t_j, y_j, f_j)``, in solve order.  ``s`` holds the
    normalized node times ``(t - t0) / (t1 - t0)`` (increasing whichever way
    the solve ran); ``ys``/``fs`` have the state's structure with a leading
    node axis; ``n`` is the node count."""

    s: torch.Tensor
    ys: Any
    fs: Any
    n: int
    t0: torch.Tensor
    t1: torch.Tensor


def eval_dense(dense: DenseSolution, t) -> State:
    """The interpolant at scalar time ``t`` (clamped to the span).  Runs on
    the device with no host read, so the quadrature adjoint can call it per
    evaluation."""
    span = dense.t1 - dense.t0
    s = torch.clamp((torch.as_tensor(t, dtype=dense.s.dtype, device=dense.s.device) - dense.t0)
                    / span, 0.0, 1.0)
    i = torch.clamp(torch.searchsorted(dense.s, s.reshape(1), right=True) - 1, 0,
                    dense.n - 2)[0]
    s_a, s_b = dense.s[i], dense.s[i + 1]
    h_s = s_b - s_a
    theta = torch.clamp((s - s_a) / torch.where(h_s == 0, torch.ones_like(h_s), h_s), 0.0, 1.0)
    h_t = h_s * span  # segment length in time units (f is dy/dt)

    def interp(y_nodes, f_nodes):
        ya, yb, fa, fb = y_nodes[i], y_nodes[i + 1], f_nodes[i], f_nodes[i + 1]
        dy = yb - ya
        th, ht = theta.to(ya.dtype), h_t.to(ya.dtype)
        b = fa * ht
        c = 3.0 * dy - (2.0 * fa + fb) * ht
        d = -2.0 * dy + (fa + fb) * ht
        return ya + th * (b + th * (c + th * d))

    return _like(dense.ys, [interp(a, b) for a, b in zip(_leaves(dense.ys), _leaves(dense.fs))])


def _dense_solve(run, y0: State, t0, t1, cfg: SolverConfig):
    """Run an adaptive loop (``run(t0, t1, on_accept) -> _Loop``) keeping its
    accepted nodes: ``(y1, stats, DenseSolution)``.  At most
    ``cfg.dense_max_nodes`` nodes are kept; a solve that accepts more steps
    than that NaN-poisons the result and the nodes, as does budget exhaustion
    (a truncated interpolant would give silently wrong quadrature-adjoint
    gradients)."""
    max_nodes = int(cfg.dense_max_nodes)
    t0_, t1_, tdt = _times(y0, t0, t1)
    span = t1_ - t0_
    s_nodes: List[torch.Tensor] = []
    y_nodes: List[State] = []
    f_nodes: List[State] = []
    count = [0]

    def on_accept(t, y, k):
        idx = min(count[0], max_nodes - 1)  # an overflowing node overwrites the last slot
        for buf, v in ((s_nodes, (t - t0_) / span), (y_nodes, y), (f_nodes, k)):
            if idx < len(buf):
                buf[idx] = v
            else:
                buf.append(v)
        count[0] += 1

    loop = run(t0_, t1_, on_accept)
    n = count[0]
    ok = loop.done and n <= max_nodes
    stack = lambda nodes: _like(y0, [_poison(torch.stack([_leaves(v)[j] for v in nodes]), ok)
                                     for j in range(len(_leaves(y0)))])
    dense = DenseSolution(torch.stack(s_nodes).to(tdt), stack(y_nodes), stack(f_nodes),
                          min(n, max_nodes), t0_, t1_)
    return (_poison(loop.y, ok), SolverStats(loop.nfe, loop.nacc, loop.steps - loop.nacc,
                                             loop.dt), dense)


def odeint_dopri5_dense(f: ODEFunc, y0: State, t0, t1, args,
                        cfg: SolverConfig) -> Tuple[State, SolverStats, DenseSolution]:
    """:func:`odeint_dopri5` that also returns a :class:`DenseSolution` over
    its accepted nodes and their FSAL derivatives (see :func:`_dense_solve`
    for the node cap and the poison)."""
    args, dt0_override = _pop_dt0(args)
    return _dense_solve(lambda a, b, on_accept: _adaptive_loop(
        f, y0, a, b, args, cfg, None, dt0_override, on_accept), y0, t0, t1, cfg)


# ---- variable-step, variable-order Adams-Bashforth-Moulton PECE ----

# 7-point Gauss-Legendre on [-1, 1]: exact to degree 13, which covers every
# Lagrange basis polynomial below (degree <= ABM_MAX_ORDER - 1 = 11)
_GL7 = (
    (-0.9491079123427585, 0.1294849661688706),
    (-0.7415311855993945, 0.2797053914892766),
    (-0.4058451513773972, 0.3818300505051183),
    (0.0, 0.4179591836734690),
    (0.4058451513773972, 0.3818300505051183),
    (0.7415311855993945, 0.2797053914892766),
    (0.9491079123427585, 0.1294849661688706),
)

# Milne error factors of the k-step pair, 2 |C_AM / (C_AB - C_AM)| on a
# uniform grid (the JAX package's values: doubled, because on variable grids
# the uniform constants under-estimate)
_MILNE = (1.0, 1 / 3, 0.2, 19 / 135, 27 / 251, 863 / 9975,
          1375 / 19087, 33953 / 551985,
          57281 / 1070017, 3250433 / 68730849,
          1135053 / 26842253, 13695779093 / 358650016725)
assert len(_MILNE) == ABM_MAX_ORDER


def _gl7(tdt, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor([x for x, _ in _GL7], dtype=tdt, device=device),
            torch.tensor([w for _, w in _GL7], dtype=tdt, device=device))


def _lagrange_quad_weights(taus: torch.Tensor, a, b, active=None, gl=None) -> torch.Tensor:
    """``w_j = int_a^b l_j(s) ds`` for the Lagrange basis on the nodes
    ``taus`` (``(..., L)``; each leading index one node set), by GL7, which is
    exact here.  ``active`` (``(..., L)`` bool) leaves nodes out of a set:
    their factors are 1 and their weights 0.  Coincident nodes (the ring's
    stale slots during the order ramp) give finite garbage, never Inf/NaN.
    ``gl``: the GL7 points and weights on the device (made here if None)."""
    L = taus.shape[-1]
    xi, om = gl if gl is not None else _gl7(taus.dtype, taus.device)
    mid, half = 0.5 * (a + b), 0.5 * (b - a)
    s = mid + half * xi  # (7,)
    num = s[:, None] - taus[..., None, :]  # (..., 7, m): s - t_m
    diff = taus[..., :, None] - taus[..., None, :]  # (..., j, m): t_j - t_m
    ratio = num[..., :, None, :] / diff.masked_fill(diff == 0, 1.0)[..., None, :, :]  # (..., 7, j, m)
    skip = torch.eye(L, dtype=torch.bool, device=taus.device)
    if active is not None:
        skip = skip | ~active[..., None, :]
    basis = torch.prod(ratio.masked_fill(skip[..., None, :, :], 1.0), dim=-1)
    ws = half * torch.sum(om[:, None] * basis, dim=-2)  # (..., j)
    return ws if active is None else ws.masked_fill(~active, 0.0)


class _AbmTables(NamedTuple):
    """Device constants of an order-``K`` solve, indexed by order ``k`` in
    ``0..K+1`` (rows 0 and K+1 stand in for the candidates outside [1, K])."""

    pred: torch.Tensor  # (K+2, K+1): active nodes of [ts_h, pad] for the predictor
    corr: torch.Tensor  # (K+2, K+1): active nodes of [t_new, ts_h] for the corrector
    milne: torch.Tensor  # (K+2,) time dtype
    inv_order: torch.Tensor  # (K+2,) float32: 1 / (k + 1)
    three: torch.Tensor  # (3,) int64: 0, 1, 2 (the candidates' offsets from k - 1)
    gl: Tuple[torch.Tensor, torch.Tensor]  # GL7 points and weights


def _abm_tables(K: int, tdt, device) -> _AbmTables:
    k = torch.arange(K + 2, device=device)[:, None]
    j = torch.arange(K + 1, device=device)[None, :]
    pred = j < torch.clamp(k, max=K)
    corr = (j == 0) | (j <= torch.clamp(k - 1, min=1))
    milne = torch.tensor((1.0,) + _MILNE[:K] + (1.0,), dtype=tdt, device=device)
    inv = torch.ones(K + 2, dtype=torch.float32, device=device) / (
        torch.arange(K + 2, device=device).to(torch.float32) + 1.0)
    return _AbmTables(pred, corr, milne, inv, torch.arange(3, device=device),
                      _gl7(tdt, device))


def _abm_weights_branch3(k, K: int, ts_h: torch.Tensor, t_new, tables=None):
    """Weights of the three candidate orders ``{k-1, k, k+1}``: ``(w_pred (3,
    K), wc_new (3,), wc_hist (3, K), milne (3,))`` in the time dtype, from one
    batched quadrature over six node sets.  ``k`` is an int or a 0-d int64
    tensor (the device loop's order): it only picks the candidates' rows of
    the tables, what JAX's ``lax.switch`` over the orders computes.  A
    candidate outside [1, K] gets finite weights of a stand-in order; the
    caller gives it an infinite error ratio."""
    if tables is None:
        tables = _abm_tables(K, ts_h.dtype, ts_h.device)
    rows = tables.three + (k - 1)
    t = ts_h[0]
    nodes = torch.cat([torch.cat([ts_h, t_new.reshape(1)]).expand(3, K + 1),
                       torch.cat([t_new.reshape(1), ts_h]).expand(3, K + 1)])
    w = _lagrange_quad_weights(nodes, t, t_new,
                               torch.cat([tables.pred[rows], tables.corr[rows]]), tables.gl)
    return w[:3, :K], w[3:, 0], w[3:, 1:], tables.milne[rows]


def _abm_weights_order(k: int, K: int, ts_h: torch.Tensor, t_new):
    """``(w_pred (K,), wc_new, wc_hist (K,), milne)`` of the single order
    ``k``: the predictor over the ``k`` newest history nodes, the corrector
    over the new node and the ``max(k - 1, 1)`` newest."""
    w_pred, wc_new, wc_hist, milne = _abm_weights_branch3(k, K, ts_h, t_new)
    return w_pred[1], wc_new[1], wc_hist[1], milne[1]


def _hist_dot(ws: torch.Tensor, f_hist: State) -> State:
    """``sum_j ws[..., j] * f_hist[j]`` over the leading history axis of
    each leaf (``ws`` cast to the leaf's dtype)."""
    return _like(f_hist, [torch.tensordot(ws.to(l.dtype), l, dims=([ws.ndim - 1], [0]))
                          for l in _leaves(f_hist)])


def _candidate_ratios(e3, y, y3, rtol, atol, error_weight) -> torch.Tensor:
    """``_rms_error_ratio`` of each of three stacked candidates: ``(3,)``,
    over the ranks of a sharded step in one collective."""
    weights = _leaves(error_weight) if error_weight is not None else None
    parts = _norm_parts()
    for i, (e, a, b) in enumerate(zip(e3, _leaves(y), y3)):
        w = True if weights is None else weights[i]
        if not w:
            continue
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        r = (e / scale).to(torch.float32)
        part = parts[w]
        part[0] = part[0] + torch.sum((r * r).reshape(3, -1), dim=1)
        part[1] += a.numel()
    return torch.sqrt(_parts_mean(parts))


class _AbmControl(NamedTuple):
    """What an abm trial step needs besides its state (fixed over a solve)."""

    K: int
    cfg: SolverConfig
    error_weight: object
    t1: torch.Tensor
    direction: torch.Tensor
    tol_done: torch.Tensor
    give_up: torch.Tensor
    tdt: torch.dtype
    tables: _AbmTables


class _AbmState(NamedTuple):
    """An abm solve between trial steps: the node ``(t, y)``, the next step
    ``dt``, the history ring ``(ts_h, fs_h)`` (slot 0 the newest; ``fs_h``
    one ``(K, ...)`` tensor a leaf), the distinct nodes in it ``n_h`` and the
    order, both 0-d int64 tensors."""

    t: torch.Tensor
    y: State
    dt: torch.Tensor
    ts_h: torch.Tensor
    fs_h: Tuple[torch.Tensor, ...]
    n_h: torch.Tensor
    order: torch.Tensor


def _abm_start(f, y0, t0, t1, args, cfg, error_weight):
    """The abm solve's set-up, shared by the eager and the device loop:
    ``(ctl, state, f0)`` with ``f0 = f(t0, y0)`` in the ring's slot 0 and the
    fixed-fraction first step (the order-1 ramp needs a small one)."""
    K = int(cfg.abm_order)
    assert 1 <= K <= ABM_MAX_ORDER
    t0, t1, tdt = _times(y0, t0, t1)
    span = t1 - t0
    ctl = _AbmControl(K, cfg, error_weight, t1, torch.sign(span),
                      1e-12 * torch.clamp(torch.abs(t1), min=1.0), _DT_GIVE_UP * torch.abs(span),
                      tdt, _abm_tables(K, tdt, t0.device))
    f0 = f(t0, y0, args)
    dt = span * torch.as_tensor(DEFAULT_FIXED_DT0 if isinstance(cfg.dt0, str) else cfg.dt0,
                                dtype=tdt)
    fs_h = tuple(torch.cat([l[None], torch.zeros((K - 1,) + l.shape, dtype=l.dtype,
                                                 device=l.device)]) for l in _leaves(f0))
    one = torch.ones((), dtype=torch.int64, device=t0.device)
    return ctl, _AbmState(t0, y0, dt, t0.repeat(K), fs_h, one, one.clone()), f0


class _AbmTrial(NamedTuple):
    """One trial step's outcome: the state it leaves on accept (``dt`` is
    the next step either way), the corrected node's derivative ``f_corr``
    and the flags as 0-d bool tensors."""

    state: _AbmState
    f_corr: State
    accept: torch.Tensor
    done: torch.Tensor
    fail: torch.Tensor


def _abm_trial(ctl: _AbmControl, f, s: _AbmState, args) -> _AbmTrial:
    """One PECE trial step from ``s`` and its decision, shared by the eager
    and the device loop so that both take the same steps: predict with the
    current order's Adams-Bashforth weights, evaluate, correct with each
    candidate order's Adams-Moulton weights, evaluate at the current order's
    corrected state (the node derivative), and take the Milne estimate of
    each candidate.  On accept the order moves to whichever of ``{k-1, k,
    k+1}`` has the smallest ratio (decrease on ties), and the step factor
    takes the exponent ``1 / (order + 1)`` of the order it leaves.  The order
    and the history count are tensors, so nothing here reads the device."""
    cfg, K, tables = ctl.cfg, ctl.K, ctl.tables
    order, n_h = s.order, s.n_h
    dt_c = ctl.direction * torch.minimum(torch.abs(s.dt), torch.abs(ctl.t1 - s.t))
    t_new = _land(ctl, s.t + dt_c)
    w_pred, wc_new, wc_hist, milne = _abm_weights_branch3(order, K, s.ts_h, t_new, tables)
    # the three candidates' predictor and corrector increments, one contraction a leaf
    inc = _hist_dot(torch.cat([w_pred, wc_hist]), _like(s.y, s.fs_h))
    y_lv = _leaves(s.y)
    y_pred3 = [yl + d[:3] for yl, d in zip(y_lv, _leaves(inc))]
    # the predictor at the current order: its evaluation serves all three
    f_pred = _leaves(f(t_new, _like(s.y, [p[1] for p in y_pred3]), args))
    y_corr3, err3 = [], []
    for yl, fl, p, d in zip(y_lv, f_pred, y_pred3, _leaves(inc)):
        shape = (3,) + (1,) * fl.ndim
        c = yl + wc_new.to(fl.dtype).reshape(shape) * fl + d[3:]
        y_corr3.append(c)
        err3.append(milne.to(c.dtype).reshape(shape) * (c - p))
    r3 = _candidate_ratios(err3, s.y, y_corr3, cfg.rtol, cfg.atol, ctl.error_weight)
    # invalid candidates never win: order 0 does not exist, and order k + 1
    # needs k + 1 distinct history nodes
    r3 = r3.masked_fill(torch.stack([order == 1, torch.zeros_like(order == 1),
                                     (order == K) | (n_h < order + 1)]), float("inf"))
    r_lo, ratio, r_hi = r3[0], r3[1], r3[2]
    y_corr = _like(s.y, [c[1] for c in y_corr3])
    # PECE second evaluate: the history's derivative at the corrected state
    f_corr = f(t_new, y_corr, args)

    finite = torch.isfinite(ratio)
    accept = finite & (ratio <= 1.0)
    dec = r_lo <= ratio  # decrease preferred on ties
    grow = (r_hi < ratio) & ~dec
    done = accept & (torch.abs(ctl.t1 - t_new) <= ctl.tol_done)
    fail = ~finite & (torch.abs(dt_c) <= ctl.give_up)
    # the step factor of each outcome (decrease, increase, keep, reject),
    # with the exponent 1 / (order + 1) of the order each one leaves
    nh_acc = torch.clamp(n_h + 1, max=K)
    orders = torch.stack([torch.clamp(order - 1, min=1), torch.minimum(order + 1, nh_acc),
                          torch.minimum(order, nh_acc), order])
    _fin, factor4 = _controller_factor(torch.stack([r_lo, r_hi, ratio, ratio]),
                                       tables.inv_order[orders], cfg.safety, cfg.min_factor,
                                       2.0, ctl.tdt)
    branch = torch.where(accept, torch.where(dec, 0, torch.where(grow, 1, 2)), 3)
    ts_acc = torch.cat([t_new.reshape(1), s.ts_h[:-1]])
    fs_acc = tuple(torch.cat([fl[None], h[:-1]]) for fl, h in zip(_leaves(f_corr), s.fs_h))
    pick = lambda v: torch.index_select(v, 0, branch.reshape(1))[0]  # no .item() in a trace
    new = _AbmState(t_new, y_corr, dt_c * pick(factor4), ts_acc, fs_acc, nh_acc, pick(orders))
    return _AbmTrial(new, f_corr, accept, done, fail)


def _abm_loop(f, y0, t0, t1, args, cfg, error_weight, on_accept=None) -> _Loop:
    """The PECE loop of :func:`odeint_abm` and its dense form, one
    :func:`_abm_trial` a trial step and one host read of its accept, done
    and fail.  ``on_accept(t, y, f)`` sees every accepted node, ``t0``
    first."""
    ctl, s, f0 = _abm_start(f, y0, t0, t1, args, cfg, error_weight)
    nfe, steps, nacc, done = 1, 0, 0, False
    if on_accept is not None:
        on_accept(s.t, s.y, f0)
    while steps < cfg.max_steps:
        with profiling.span("ode.trial"):
            trial = _abm_trial(ctl, f, s, args)
            flags = torch.stack([trial.accept, trial.done, trial.fail])
            # the one host read of the trial step
            with profiling.host_read("ode.trial"):
                acc, done, fail = flags.tolist()
        nfe, steps = nfe + 2, steps + 1
        if acc:
            nacc += 1
            s = trial.state
            if on_accept is not None:
                on_accept(s.t, s.y, trial.f_corr)
        else:
            s = s._replace(dt=trial.state.dt)
        if done or fail:
            break
    return _Loop(s.y, s.dt, nfe, steps, nacc, done)


def _abm_device_loop(f, y0, t0, t1, args, cfg) -> Tuple[State, SolverStats]:
    """:func:`_abm_loop` with its control on the device: one ``while_loop``
    whose carry holds the :class:`_AbmState` (the order a tensor), the step
    counts and the done/fail flags; accept and reject by ``torch.where``, so
    ``torch.export`` captures it.  The set-up and the trial step are the
    eager loop's, so both take the same steps and give the same bits."""
    from torch._higher_order_ops.while_loop import while_loop

    ctl, s0, _f0 = _abm_start(f, y0, t0, t1, args, cfg, None)
    n_y = len(_leaves(y0))
    count = lambda: torch.zeros((), dtype=torch.int64, device=s0.t.device)
    flag = lambda: torch.zeros((), dtype=torch.bool, device=s0.t.device)

    def cond(steps, nacc, done, fail, *carry):
        return ~(done | fail) & (steps < cfg.max_steps)

    def body(steps, nacc, done, fail, t, dt, ts_h, n_h, order, *leaves):
        s = _AbmState(t, _like(y0, leaves[:n_y]), dt, ts_h, tuple(leaves[n_y:]), n_h, order)
        trial = _abm_trial(ctl, f, s, args)
        new, keep = trial.state, lambda a, b: torch.where(trial.accept, a, b)
        return (steps + 1, nacc + trial.accept.to(torch.int64), trial.done, trial.fail,
                keep(new.t, t), new.dt, keep(new.ts_h, ts_h), keep(new.n_h, n_h),
                keep(new.order, order),
                *[keep(a, b) for a, b in zip(_leaves(new.y) + new.fs_h, leaves)])

    steps, nacc, done, _fail, _t, dt, *rest = while_loop(
        cond, body, (count(), count(), flag(), flag(), s0.t, s0.dt, s0.ts_h, s0.n_h, s0.order,
                     *_leaves(s0.y), *s0.fs_h))
    y = _like(y0, [torch.where(done, l, torch.full_like(l, float("nan")))
                   for l in rest[3:3 + n_y]])
    return y, SolverStats(1 + 2 * steps, nacc, steps - nacc, dt)


def odeint_abm(f: ODEFunc, y0: State, t0, t1, args, cfg: SolverConfig,
               error_weight=None) -> Tuple[State, SolverStats]:
    """Variable-step, variable-order Adams-Bashforth-Moulton PECE, orders 1
    to ``cfg.abm_order``: the history is a ring of the last ``abm_order``
    ``(t, f)`` pairs, the weights are recomputed each step from the node
    times (Lagrange basis, GL7 quadrature), the order moves on accept to
    whichever of ``{k-1, k, k+1}`` has the smallest Milne ratio, and the step
    grows at most 2x.  The start is the fixed fraction of the span (a float
    ``cfg.dt0`` is that fraction); a carried ``args["dt0"]`` is popped and
    ignored, as in the JAX package.  ``nfe = 1 + 2 *
    steps``; budget exhaustion or a non-finite field NaN-poisons the result."""
    args, _ignored = _pop_dt0(args)
    run = _abm_loop(f, y0, t0, t1, args, cfg, error_weight)
    return _poison(run.y, run.done), SolverStats(run.nfe, run.nacc, run.steps - run.nacc, run.dt)


def odeint_abm_dense(f: ODEFunc, y0: State, t0, t1, args,
                     cfg: SolverConfig) -> Tuple[State, SolverStats, DenseSolution]:
    """:func:`odeint_abm` with a :class:`DenseSolution` over its accepted
    nodes: the corrected states and their second-evaluate derivatives, at no
    extra evaluation (see :func:`_dense_solve` for the node cap and the
    poison).  With the quadrature adjoint this is the reference's default
    stack, VCABM with ``QuadratureAdjoint``."""
    args, _ignored = _pop_dt0(args)
    return _dense_solve(lambda a, b, on_accept: _abm_loop(f, y0, a, b, args, cfg, None,
                                                          on_accept), y0, t0, t1, cfg)


def odeint(f: ODEFunc, y0: State, t0, t1, args, cfg: SolverConfig, error_weight=None,
           dt0_override=None) -> Tuple[State, SolverStats]:
    """Dispatch on ``cfg.method``.  ``error_weight`` marks the state leaves
    that enter the adaptive error norm (the adjoint's seminorm; ignored by
    fixed steps).  ``dt0_override``: an explicit starting step (the backward
    adjoint solve's); ``args["dt0"]`` is the channel for calls that cross an
    autograd boundary, and an explicit override wins over it (``abm``
    ignores both)."""
    if cfg.method in _TABLEAUS:
        return odeint_dopri5(f, y0, t0, t1, args, cfg, error_weight, dt0_override)
    if cfg.method == "abm":
        return odeint_abm(f, y0, t0, t1, args, cfg, error_weight)
    return odeint_fixed(f, y0, t0, t1, args, cfg)


def odeint_dense(f: ODEFunc, y0: State, t0, t1, args,
                 cfg: SolverConfig) -> Tuple[State, SolverStats, DenseSolution]:
    """Dense-output dispatch: every adaptive method (dopri5, tsit5, abm)."""
    if cfg.method in _TABLEAUS:
        return odeint_dopri5_dense(f, y0, t0, t1, args, cfg)
    if cfg.method == "abm":
        return odeint_abm_dense(f, y0, t0, t1, args, cfg)
    raise ValueError(
        f"dense output needs an adaptive method (dopri5/tsit5/abm), got {cfg.method!r}"
    )
