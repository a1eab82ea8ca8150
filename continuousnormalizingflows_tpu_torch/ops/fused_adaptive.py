"""K5 and K6: the whole adaptive dopri5 solve of the augmented state in one
launch, and its exact discrete backward in another.

Counterpart of ``continuousnormalizingflows_tpu.ops.pallas_adaptive``.  The
state per row is ``u = [z (nz), dlogp, E, n]`` and each stage is the fused
dynamics of :mod:`.fused_dynamics`, as in K3.  The solve is Dormand-Prince
5(4) with FSAL and the JAX kernel's controller, run per **control group**
of rows: each group takes its own step sequence, with the RMS error over
its rows and every state column, the exp/log step factor, accept/reject,
the give-up on a non-finite field and the NaN poison of a group that does
not finish within ``max_steps``.  One stats row per group: ``[nfe, naccept,
nreject, dt_final]`` (:func:`stats_from_rows` folds them).

The backward (K6) takes each group's accepted steps ``(u, t, dt)``, at
most ``max_nodes`` of them (from K5's record on the cluster path, below;
else it replays the forward's controller into a node buffer), then walks
them backward through the 6-stage dopri5
chain rule, ``kbar_i = dt b_i a + dt sum_{m > i} a_mi vbar_m``, with the
stage VJP of :mod:`.fused_dynamics`.  The accept decisions and step sizes
are not differentiated.  A group that accepted more steps than the buffer
holds, or did not finish, NaN-poisons its rows of ``u0bar``/``epsbar`` and
every weight gradient.  On the card, for hidden widths <= 32, the replay
and the walk are two kernels: the replay one block a group like K5, the
walk one row a thread in blocks of 64 rows within a group.  For 32 < h <=
128 both kernels run a thread-block cluster of 2 or 4 CTAs a group
(``_build.cluster_plan``), the weights resident in shared memory where they
fit: the wrapper builds their image (:func:`_weight_image`).

**K5's record** (the cluster path).  Where the solve will be taken back
(:func:`_wants_backward`), K5 records each accepted step's six stage inputs
``v_0 .. v_5`` (z columns, the values its stages were evaluated at), their
``t`` and ``dt``, and each group's accepted count and done flag
(:class:`_Record`).  K6 walks that record: it neither replays the solve nor
recomputes the stage inputs from the node (five stage forwards an accepted
step), which the row and tiled paths still do.  The record is
``max_nodes x 6 x nz x B`` float32, 6x the replay's node buffer: 3.42 GB
at ``nz = 17``, ``B = 65,536`` and 128 nodes.  It is ``torch.empty``, held
from K5 to K6 by the autograd Function and freed by its backward.  Scoring,
sampling and ``torch.no_grad`` make none; :func:`fused_solve_dopri5_bwd`
(no K5 before it) has K5's kernel write one first.

**The route is the semantics here.**  Per-group step control gives other
answers than the global-norm solve of :mod:`.ode` (by O(tol)), so the same
config must take the same route in both packages: the gate keeps the JAX
limits (hidden, net-input and state widths <= 128) and the JAX tile rule
(the batch is whole 128-row groups, or at most 128 rows and a multiple of
8), without its TPU-backend check.  The group is 128 rows in the forward
and the backward alike (the JAX forward takes 256-row tiles where the
batch divides by 256 while its backward replays 128-row ones).  The node
buffer lives in device memory, so ``max_nodes`` is honored as given (the
JAX package caps it at 64 for the TPU's VMEM).

:func:`fused_solve_dopri5` takes the plain versions for CPU tensors and the
CUDA kernels (``csrc/fused_adaptive.cu``, ``csrc/fused_adaptive_bwd.cu``)
for CUDA tensors.  The stages run in float32 whatever the net's precision,
as in the JAX kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import DEFAULT_FIXED_DT0, ICNFConfig, Mode, SolverConfig, TraceEstimator
from ..models.nets import MLP, Params
from . import _build
from ..utils import profiling
from .fused_dynamics import (_ptr, fused_dynamics_vjp_bwd_reference, kernel_operands,
                             mlp3_forward_vjp_reference, params_of, split_grads, transposes,
                             weights_of)
from .fused_solve import _check_solve, _stage_input
from .ode import _DT_GIVE_UP, DOPRI5, SolverStats
from ..parallel import mesh as pmesh

__all__ = [
    "fused_adaptive_applicable",
    "fused_adaptive_tile",
    "fused_solve_dopri5",
    "fused_solve_dopri5_bwd",
    "fused_solve_dopri5_reference",
    "fused_solve_dopri5_bwd_reference",
    "stats_from_rows",
    "MAX_WIDTH",
]

# hidden, net-input and state widths of the gate (the JAX kernel's lane tile)
MAX_WIDTH = 128
# rows of a control group (the JAX backward's tile)
_GROUP = 128
# a test hook: the path of K5 and K6 for 32 < h <= 128, None the plan's
# (_build.cluster_plan), "tiled", "cluster", or "cluster2" / "cluster4" (that
# many CTAs a group) to time or test one (a cluster path raises where it does
# not fit)
_WIDE_PATH: Optional[str] = None
_PATH_ARG = {None: -1, "tiled": 0, "cluster": 1, "cluster2": 2, "cluster4": 4}

_A = DOPRI5.A
_B = DOPRI5.B
_BERR = DOPRI5.BERR
_C = DOPRI5.C
_INV_ORDER = 1.0 / DOPRI5.order
_N_STAGES = len(_B)  # 6 solution stages; the 7th (FSAL) feeds the error and the next k1


def fused_adaptive_applicable(cfg: ICNFConfig, net, mode: Mode) -> bool:
    """The JAX gate (``pallas_adaptive.fused_adaptive_applicable``) with a
    float32 check in place of its TPU-backend check (a float64 config
    solves unfused, as JAX's does on the CPU): ``fused`` and
    ``fused_adaptive``, dopri5 with the
    adjoint setting (which the kernels replace by the exact discrete
    backward), regularized train mode with both RNODE norms, one
    Hutchinson-VJP probe, a 3-layer softplus MLP with equal hidden widths
    and every width <= 128."""
    return (
        cfg.fused
        and cfg.dtype == torch.float32
        and cfg.fused_adaptive
        and cfg.layout == "batch_first"
        and cfg.solver.method == "dopri5"
        and cfg.solver.gradient == "adjoint"
        and mode is Mode.TRAIN
        and cfg.norm_z
        and cfg.norm_j
        and cfg.trace_for(mode) is TraceEstimator.HUTCH_VJP
        and cfg.nprobes == 1
        and isinstance(net, MLP)
        and len(net.widths) == 4
        and net.widths[1] == net.widths[2]
        and net.widths[1] <= MAX_WIDTH
        and net.activation is F.softplus
        and cfg.n_in <= MAX_WIDTH
        and cfg.state_dim <= MAX_WIDTH
    )


def fused_adaptive_tile(batch: int, whole_groups: bool = False) -> Optional[int]:
    """Rows of a control group for this batch, or None where the batch makes
    no whole groups (the JAX ``_tile_for(batch, 128)``).  ``whole_groups``:
    ``batch`` is a rank's shard of a batch split over ranks, which takes the
    kernels only as whole 128-row groups: one process's groups of the whole
    batch, each stepping alone, so no collective is needed.  Every rank
    holds as many rows, so all take the same route; a shard of another size
    raises rather than leave the kernels for the unfused loop."""
    if whole_groups and batch % _GROUP:
        raise ValueError(f"fused_adaptive=True on a batch split over the data axis takes "
                         f"the kernels on whole {_GROUP}-row control groups: a rank holds "
                         f"{batch} rows, it needs a multiple of {_GROUP}")
    g = min(_GROUP, batch)
    return g if g > 0 and batch % g == 0 and g % 8 == 0 else None


def stats_from_rows(rows: torch.Tensor, tdt=torch.float32) -> SolverStats:
    """One :class:`SolverStats` from the per-group rows: the worst group's
    NFE, accepted and rejected counts (the critical path) and the
    smallest-magnitude final step, as 0-d device tensors (no host read).
    Inside a sharded step, over every rank's groups (one collective)."""
    worst = torch.amax(rows[:, :3], dim=0)
    with profiling.host_read("solve.stats"):  # indexing by a device scalar reads it
        dt = rows[torch.argmin(torch.abs(rows[:, 3])), 3]
    if pmesh.active() is not None:
        both = pmesh.reduce_max(torch.cat([worst, -torch.abs(dt)[None]]))
        worst, dt = both[:3], torch.sign(dt) * -both[3]
    nfe, nacc, nrej = (worst[i].to(torch.int32) for i in range(3))
    return SolverStats(nfe, nacc, nrej, dt.to(tdt))


def _scfg_tuple(solver: SolverConfig):
    """``(rtol, atol, dt0, safety, min_factor, max_factor, max_steps)``;
    ``dt0="auto"``/``"carry"`` map to the fixed start, as in the JAX kernel."""
    return (
        float(solver.rtol),
        float(solver.atol),
        DEFAULT_FIXED_DT0 if isinstance(solver.dt0, str) else float(solver.dt0),
        float(solver.safety),
        float(solver.min_factor),
        float(solver.max_factor),
        int(solver.max_steps),
    )


# ---- plain versions ----

def _trial_step(fstage, t, u, dt_c, k1):
    """One embedded trial ``(u5, err, k7)``; ``t`` and ``dt_c`` per row."""
    ks = [k1]
    for i, row in enumerate(_A):
        vi = u
        for c, k in zip(row, ks):
            if c != 0.0:
                vi = vi + dt_c * c * k
        ks.append(fstage(t + _C[i + 1] * dt_c, vi))
    u5 = u
    for c, k in zip(_B, ks):
        if c != 0.0:
            u5 = u5 + dt_c * c * k
    k7 = fstage(t + dt_c, u5)
    ks.append(k7)
    err = dt_c * _BERR[0] * ks[0]
    for c, k in zip(_BERR[1:], ks[1:]):
        if c != 0.0:
            err = err + dt_c * c * k
    return u5, err, k7


def _group_error_ratio(err, u, u5, group: int, rtol: float, atol: float):
    """RMS of ``err / (atol + rtol max(|u|, |u5|))`` over each group's rows
    and every state column: ``(groups,)``."""
    scale = atol + rtol * torch.maximum(torch.abs(u), torch.abs(u5))
    r = err / scale
    return torch.sqrt(torch.sum((r * r).reshape(-1, group * u.shape[1]), dim=1)
                      / (group * u.shape[1]))


def _controller(ratio, dt_c, safety, min_factor, max_factor):
    """Non-finite-safe controller with ``ratio**(-1/5)`` as exp/log (the JAX
    kernel's form): ``(finite, dt_next)``."""
    finite = torch.isfinite(ratio)
    r = torch.clamp(torch.where(finite, ratio, torch.ones_like(ratio)), min=1e-10)
    factor = torch.clamp(safety * torch.exp(-_INV_ORDER * torch.log(r)), min_factor, max_factor)
    return finite, dt_c * torch.where(finite, factor, torch.full_like(factor, min_factor))


class _Replay(NamedTuple):
    u: torch.Tensor  # (B, sd) at exit
    rows: torch.Tensor  # (G, 4) stats
    done: torch.Tensor  # (G,) bool
    nacc: torch.Tensor  # (G,) int
    traj: Optional[torch.Tensor]  # (max_nodes, B, nz): u of each accepted step
    ts: Optional[torch.Tensor]  # (max_nodes, G)
    dts: Optional[torch.Tensor]  # (max_nodes, G)


def _times(u0, tspan):
    # a float end is copied to the card from pageable memory: it waits for the stream
    with profiling.host_read("solve.times"):
        return tuple(torch.as_tensor(t, dtype=u0.dtype, device=u0.device) for t in tspan)


def _stage_fn(eps, ys, params, nz, t_col):
    def fstage(t_rows, u):
        y, _ez, div, reg_z, reg_j = mlp3_forward_vjp_reference(
            _stage_input(t_rows, u[:, :nz], ys, t_col), eps, params, nz)
        return torch.cat([y, -div[:, None], reg_z[:, None], reg_j[:, None]], dim=-1)

    return fstage


def _replay(u0, eps, ys, params, t0, t1, nz, t_col, scfg, group, max_nodes=0) -> _Replay:
    """Every group's adaptive solve, vectorised over groups: a group that has
    finished or failed keeps its state while the others step on.  One host
    read per trial step.  With ``max_nodes`` the accepted steps are recorded
    (an overflowing step overwrites the last node, as in the JAX kernel)."""
    rtol, atol, dt0f, safety, min_f, max_f, max_steps = scfg
    b, _sd = u0.shape
    n_groups = b // group
    dev = u0.device
    span = t1 - t0
    direction = torch.sign(span)
    tiny = 1e-12 * torch.clamp(torch.abs(t1), min=1.0)
    fstage = _stage_fn(eps, ys, params, nz, t_col)

    def per_row(v):
        return v.repeat_interleave(group)[:, None]

    t = t0.expand(n_groups).clone()
    dt = (span * dt0f).expand(n_groups).clone()
    u = u0
    k1 = fstage(per_row(t), u)
    nfe = torch.ones(n_groups, dtype=torch.int64, device=dev)
    steps = torch.zeros_like(nfe)
    nacc = torch.zeros_like(nfe)
    done = torch.zeros(n_groups, dtype=torch.bool, device=dev)
    fail = torch.zeros_like(done)
    traj = ts = dts = None
    if max_nodes:
        traj = torch.zeros((max_nodes, b, nz), dtype=u0.dtype, device=dev)
        ts = torch.zeros((max_nodes, n_groups), dtype=torch.float32, device=dev)
        dts = torch.zeros_like(ts)
    rows_b = torch.arange(b, device=dev)
    rows_g = torch.arange(n_groups, device=dev)
    while True:
        active = ~(done | fail) & (steps < max_steps)
        if not bool(active.any()):
            break
        dt_c = direction * torch.minimum(torch.abs(dt), torch.abs(t1 - t))
        u5, err, k7 = _trial_step(fstage, per_row(t), u, per_row(dt_c), k1)
        ratio = _group_error_ratio(err, u, u5, group, rtol, atol)
        finite, dt_next = _controller(ratio, dt_c, safety, min_f, max_f)
        accept = finite & (ratio <= 1.0) & active
        if max_nodes:
            idx = torch.clamp(nacc, max=max_nodes - 1)
            idx_b = idx.repeat_interleave(group)
            acc_b = per_row(accept)
            traj[idx_b, rows_b] = torch.where(acc_b, u[:, :nz], traj[idx_b, rows_b])
            ts[idx, rows_g] = torch.where(accept, t, ts[idx, rows_g])
            dts[idx, rows_g] = torch.where(accept, dt_c, dts[idx, rows_g])
        t_new = torch.where(accept, t + dt_c, t)
        t_new = torch.where(direction * (t1 - t_new) < 0, t1, t_new)  # ops/ode._land
        u = torch.where(per_row(accept), u5, u)
        k1 = torch.where(per_row(accept), k7, k1)
        done_new = accept & (torch.abs(t1 - t_new) <= tiny)
        fail_new = ~finite & (torch.abs(dt_c) <= _DT_GIVE_UP * torch.abs(span))
        t = torch.where(active, t_new, t)
        dt = torch.where(active, dt_next, dt)
        done = torch.where(active, done_new, done)
        fail = torch.where(active, fail_new, fail)
        nfe = nfe + _N_STAGES * active
        steps = steps + active
        nacc = nacc + accept
    rows = torch.stack([nfe.float(), nacc.float(), (steps - nacc).float(), dt], dim=1)
    return _Replay(u, rows, done, nacc, traj, ts, dts)


def _fwd_reference(u0, eps, ys, params, t0, t1, nz, t_col, scfg, group):
    run = _replay(u0, eps, ys, params, t0, t1, nz, t_col, scfg, group)
    ok = run.done.repeat_interleave(group)[:, None]
    return torch.where(ok, run.u, torch.full_like(run.u, float("nan"))), run.rows


def fused_solve_dopri5_reference(u0: torch.Tensor, eps: torch.Tensor,
                                 ys: Optional[torch.Tensor], params: Params, tspan, nz: int,
                                 t_col: Optional[int], scfg: tuple, group: int):
    """Plain PyTorch version of K5: ``(u1 (B, state_dim), stats rows (B //
    group, 4))``, the rows ``[nfe, naccept, nreject, dt_final]``."""
    t0, t1 = _times(u0, tspan)
    return _fwd_reference(u0, eps, ys, params, t0, t1, nz, t_col, scfg, group)


def _bwd_reference(u0, eps, ys, params, t0, t1, nz, t_col, scfg, max_nodes, gbar, group):
    b, sd = u0.shape
    run = _replay(u0, eps, ys, params, t0, t1, nz, t_col, scfg, group, max_nodes)
    ok = run.done & (run.nacc <= max_nodes)
    poison = torch.where(ok, 1.0, float("nan")).repeat_interleave(group)[:, None]
    fstage = _stage_fn(eps, ys, params, nz, t_col)
    rows_b = torch.arange(b, device=u0.device)
    rows_g = torch.arange(b // group, device=u0.device)

    def per_row(v):
        return v.repeat_interleave(group)[:, None]

    def stage_vjp(t_rows, v_z, kbar):
        cot = (kbar[:, :nz], torch.zeros_like(v_z), -kbar[:, nz], kbar[:, nz + 1],
               kbar[:, nz + 2])
        xbar, e, w = fused_dynamics_vjp_bwd_reference(
            _stage_input(t_rows, v_z, ys, t_col), eps, params, nz, cot)
        return xbar[:, :nz], e, w

    a = gbar.to(torch.float32)
    epsbar = torch.zeros_like(eps)
    wbars = [torch.zeros_like(w) for w in weights_of(params)]
    # an overflowing group is poisoned: it walks no more than the buffer holds
    for j in range(min(int(run.nacc.max()), max_nodes)):
        n = run.nacc - 1 - j
        live = per_row(n >= 0).to(a.dtype)
        n_c = torch.clamp(n, 0, max_nodes - 1)
        u = run.traj[n_c.repeat_interleave(group), rows_b]
        t = per_row(run.ts[n_c, rows_g])
        dt = per_row(run.dts[n_c, rows_g])
        # the 6 solution stages' inputs (z columns: no stage reads the rest)
        vs, ks = [u], [fstage(t, u)[:, :nz]]
        for i, row in enumerate(_A):
            vi = u
            for c, k in zip(row, ks):
                if c != 0.0:
                    vi = vi + dt * c * k
            vs.append(vi)
            if i + 1 < _N_STAGES - 1:
                ks.append(fstage(t + _C[i + 1] * dt, vi)[:, :nz])
        vbars = [None] * _N_STAGES
        for i in range(_N_STAGES - 1, -1, -1):
            kbar = (dt * _B[i]) * a if _B[i] != 0.0 else torch.zeros_like(a)
            for m in range(i + 1, _N_STAGES):
                a_mi = _A[m - 1][i]
                if a_mi != 0.0:
                    kbar = kbar + F.pad((dt * a_mi) * vbars[m], (0, sd - nz))
            vbars[i], e_i, w_i = stage_vjp(t + _C[i] * dt, vs[i], kbar * live)
            epsbar = epsbar + e_i
            wbars = [acc + w for acc, w in zip(wbars, w_i)]
        for vb in vbars:
            a = a + F.pad(vb, (0, sd - nz))
    if not bool(ok.all()):
        wbars = [w * float("nan") for w in wbars]
    return a * poison, epsbar * poison, tuple(wbars), run.nacc.to(torch.int32)


def fused_solve_dopri5_bwd_reference(u0: torch.Tensor, eps: torch.Tensor,
                                     ys: Optional[torch.Tensor], params: Params, tspan,
                                     nz: int, t_col: Optional[int], scfg: tuple,
                                     max_nodes: int, gbar: torch.Tensor, group: int):
    """Plain PyTorch version of K6.  ``gbar``: the cotangent of ``u1``.
    Returns ``(u0bar (B, state_dim), epsbar (B, nz), (dA1, db1, dA2, db2,
    dA3, db3), nacc (groups,))``, ``nacc`` being each group's accepted steps
    in the replay.  The cotangents of ``ys`` and of the time span are not
    computed, as in the TPU kernel."""
    t0, t1 = _times(u0, tspan)
    return _bwd_reference(u0, eps, ys, params, t0, t1, nz, t_col, scfg, max_nodes, gbar, group)


# ---- the CUDA kernels ----

def _check_adaptive(u0, eps, ys, weights, nz, t_col, group):
    b, sd, n_in, h, n_out, nc = _check_solve(u0, eps, ys, weights, nz, t_col)
    if max(h, n_in, sd) > MAX_WIDTH:
        raise ValueError(f"widths n_in={n_in}, h={h}, state={sd} outside the kernels' range "
                         f"(<= {MAX_WIDTH})")
    if not (0 < group <= _GROUP and group % 8 == 0 and b % group == 0):
        raise ValueError(f"batch {b} does not make whole control groups of {group} rows")
    return b, sd, n_in, h, n_out, nc


def _weight_image(weights, n_in, h, n_out, floats):
    """The weight image of the cluster path (``image_layout`` in
    ``csrc/cluster_adaptive.cuh``): A1, A2 and A3 in nn.Linear layout with
    their rows padded to an odd width, then b1, b2, b3, then zeros up to
    ``floats``."""
    a1, b1, a2, b2, a3, b3 = weights
    l1, lh = n_in | 1, h | 1
    parts = [F.pad(a1, (0, l1 - n_in)).reshape(-1), F.pad(a2, (0, lh - h)).reshape(-1),
             F.pad(a3, (0, lh - h)).reshape(-1), b1, b2, b3]
    used = sum(p.numel() for p in parts)
    return torch.cat(parts + [a1.new_zeros(floats - used)])


def _cluster_operands(weights, b, sd, n_in, h, n_out, nz, group, image=None):
    """The path argument of the kernels, their cluster plan, and the weight
    image where the cluster path holds it (K5 and K6's replay alike; else
    None): ``image`` where it is the one the plan holds (K5's, kept for K6's
    launch of the same step), else built here."""
    path = _PATH_ARG[_WIDE_PATH]
    cp = _build.cluster_plan(n_in, h, n_out, nz, sd, group, b, path)
    if not (cp.cluster and cp.image):
        image = None
    elif image is None or image.numel() != cp.image:
        image = _weight_image(weights, n_in, h, n_out, cp.image)
    return path, cp, image


def _solver_args(scfg):
    rtol, atol, dt0f, safety, min_f, max_f, max_steps = scfg
    return (int(max_steps), float(rtol), float(atol), float(dt0f), float(safety),
            float(min_f), float(max_f))


class _Record(NamedTuple):
    """K5's record for K6 on the cluster path (``csrc/cluster_adaptive.cuh``)."""

    nodes: torch.Tensor  # (max_nodes, 6, nz, B): z of each accepted step's six stage inputs
    tdt: torch.Tensor  # (groups, max_nodes, 2): each accepted step's t and dt
    nacc: torch.Tensor  # (groups,) int32: the accepted steps
    done: torch.Tensor  # (groups,) int32: whether the group finished


def _wants_backward(u0, eps, weights) -> bool:
    """Whether the solve's result will be taken back: grad mode is on and
    ``u0``, ``eps`` or a weight requires grad (inside an autograd Function's
    forward grad mode is off, and ``ctx.needs_input_grad`` does not see
    ``torch.no_grad``)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in (u0, eps, *weights))


def _record_shape(max_nodes: int, cluster: int, nz: int, b: int):
    """The shape of the record K5 writes for K6, ``(max_nodes, 6, nz, b)``,
    or None where it writes none: with no backward to feed (``max_nodes``
    0) or off the cluster path (``cluster`` 0: the row and tiled paths'
    K6 replays the solve)."""
    return (max_nodes, _N_STAGES, nz, b) if max_nodes > 0 and cluster else None


def _new_record(shape, group: int, device) -> _Record:
    max_nodes, _stages, _nz, b = shape
    n_groups = b // group
    return _Record(torch.empty(shape, dtype=torch.float32, device=device),
                   torch.empty((n_groups, max_nodes, 2), dtype=torch.float32, device=device),
                   torch.empty((n_groups,), dtype=torch.int32, device=device),
                   torch.empty((n_groups,), dtype=torch.int32, device=device))


def _call_fwd(lib, u0, eps, ys, weights, w_t, image, t0, t1, nz, t_col, scfg, group, path,
              record: Optional[_Record]):
    """One call of K5's kernel on contiguous operands: ``(u1, stats rows)``,
    and the record written where one is given."""
    a1, b1, a2, b2, a3, b3 = weights
    w1t, w2t, w3t = w_t
    b, sd = u0.shape
    n_in, h, n_out = a1.shape[1], a1.shape[0], a3.shape[0]
    nc = 0 if ys is None else ys.shape[1]
    dev = u0.device
    u1 = torch.empty_like(u0)
    rows = torch.empty((b // group, 4), dtype=torch.float32, device=dev)
    state = torch.empty((b, 9 * sd), dtype=torch.float32, device=dev)
    rec, tdt, nacc, done = record if record is not None else (None,) * 4
    max_nodes = 0 if record is None else rec.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cnf_fused_adaptive_fwd(
            _ptr(u0), _ptr(eps), _ptr(ys), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(a3),
            _ptr(b3), _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(image), _ptr(t0), _ptr(t1),
            _ptr(state), _ptr(u1), _ptr(rows), _ptr(rec), _ptr(tdt), _ptr(nacc), _ptr(done), b,
            sd, n_in, h, n_out, nz, nc, -1 if t_col is None else t_col, group, path, max_nodes,
            *_solver_args(scfg), stream,
        )
    _build.check(err, "fused_adaptive_fwd")
    return u1, rows


def _launch_fwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg, group, record_nodes=0):
    """K5 on CUDA tensors: ``(u1, stats rows, the weight image or None, K5's
    record or None)``.  ``record_nodes``: the record's depth where K6 will
    take this solve back (0: none); on the cluster path K5 then writes it
    (:func:`_record_shape`)."""
    with profiling.span("K5"):
        weights = kernel_operands(weights, u0, eps, ys, t0, t1)
        b, sd, n_in, h, n_out, nc = _check_adaptive(u0, eps, ys, weights, nz, t_col, group)
        path, cp, image = _cluster_operands(weights, b, sd, n_in, h, n_out, nz, group)
        # the products read the transposes where the weights are not in shared memory
        w_t = transposes(weights, staged=bool(cp.cluster and cp.res_fwd))
        u0, eps = u0.contiguous(), eps.contiguous()
        ys = None if ys is None else ys.contiguous()
        shape = _record_shape(record_nodes, cp.cluster, nz, b)
        record = None if shape is None else _new_record(shape, group, u0.device)
        lib = _build.kernels()
        with profiling.span("K5.call"):
            u1, rows = _call_fwd(lib, u0, eps, ys, weights, w_t, image, t0, t1, nz, t_col, scfg,
                                 group, path, record)
        profiling.count("K5.launches")
        return u1, rows, image, record


def _launch_bwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg, max_nodes, gbar, group,
                image=None, record=None):
    """K6 on CUDA tensors; ``image``: K5's weight image of the same step, if
    any; ``record``: K5's record of the same solve, if any (the cluster path
    walks it; without it K6 has K5's kernel write one first)."""
    with profiling.span("K6"):
        weights = kernel_operands(weights, u0, eps, ys, t0, t1, gbar)
        b, sd, n_in, h, n_out, nc = _check_adaptive(u0, eps, ys, weights, nz, t_col, group)
        if gbar.shape != u0.shape:
            raise ValueError(f"cotangent shape {tuple(gbar.shape)}, expected {tuple(u0.shape)}")
        if max_nodes < 1:
            raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
        a1, b1, a2, b2, a3, b3 = weights
        path, cp, image = _cluster_operands(weights, b, sd, n_in, h, n_out, nz, group, image)
        w_t = transposes(weights, staged=bool(cp.cluster and cp.res_fwd and cp.res_bwd))
        w1t, w2t, w3t = w_t
        u0, eps, gbar = u0.contiguous(), eps.contiguous(), gbar.contiguous()
        ys = None if ys is None else ys.contiguous()
        dev = u0.device
        n_groups = b // group
        n_params = sum(w.numel() for w in weights)
        u0bar = torch.empty_like(u0)
        epsbar = torch.empty_like(eps)
        # a row of weight-gradient partial sums for each block of the walk back
        # (on the cluster path, each group's cluster writes one row)
        walk_h, walk_blocks = _build.adaptive_plan(n_in, h, n_out, nz, sd, group)[5:]
        rows = n_groups * (1 if cp.cluster else walk_blocks)
        partial = torch.empty((rows, n_params), dtype=torch.float32, device=dev)
        grads = torch.empty((n_params,), dtype=torch.float32, device=dev)
        lib = _build.kernels()
        with profiling.span("K6.call"):
            state = None
            if cp.cluster:
                shape = _record_shape(max_nodes, cp.cluster, nz, b)
                if record is None:
                    record = _new_record(shape, group, dev)
                    _call_fwd(lib, u0, eps, ys, weights, w_t, image, t0, t1, nz, t_col, scfg,
                              group, path, record)
                    profiling.count("K6.replays")
                elif tuple(record.nodes.shape) != shape:
                    raise ValueError(f"K5's record {tuple(record.nodes.shape)}, expected {shape}")
                else:
                    profiling.count("K6.from_record")
                traj, tdt, nacc, done = record
            else:
                # the replay's node buffer; `done` is the row walk's own scratch (the
                # walk a kernel apart from the replay)
                state = torch.empty((b, 9 * sd), dtype=torch.float32, device=dev)
                traj = torch.empty((max_nodes, nz, b), dtype=torch.float32, device=dev)
                tdt = torch.empty((n_groups, max_nodes, 2), dtype=torch.float32, device=dev)
                nacc = torch.empty((n_groups,), dtype=torch.int32, device=dev)
                done = torch.empty((n_groups,), dtype=torch.int32, device=dev) if walk_h else None
                profiling.count("K6.replays")
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream().cuda_stream
                err = lib.cnf_fused_adaptive_bwd(
                    _ptr(u0), _ptr(eps), _ptr(ys), _ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), _ptr(a3),
                    _ptr(b3), _ptr(w1t), _ptr(w2t), _ptr(w3t), _ptr(image), _ptr(t0), _ptr(t1),
                    _ptr(gbar), _ptr(u0bar), _ptr(epsbar), _ptr(state), _ptr(traj), _ptr(tdt),
                    _ptr(partial), _ptr(grads), _ptr(nacc), _ptr(done), b, sd, n_in, h, n_out,
                    nz, nc, -1 if t_col is None else t_col, group, path, max_nodes,
                    *_solver_args(scfg), stream,
                )
        _build.check(err, "fused_adaptive_bwd")
        profiling.count("K6.launches")
        return u0bar, epsbar, split_grads(grads, n_in, h, n_out), nacc


def _device_check(u0, what):
    if u0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {u0.device}")


def _group_of(u0) -> int:
    group = fused_adaptive_tile(u0.shape[0])
    if group is None:
        raise ValueError(f"batch {u0.shape[0]} does not make whole control groups "
                         "(fused_adaptive_tile)")
    return group


def _bwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg, max_nodes, gbar, group, image=None,
         record=None):
    if u0.device.type == "cpu":
        return _bwd_reference(u0, eps, ys, params_of(weights), t0, t1, nz, t_col, scfg,
                              max_nodes, gbar, group)
    return _launch_bwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg, max_nodes, gbar, group,
                       image, record)


def fused_solve_dopri5_bwd(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                           params: Params, tspan, nz: int, t_col: Optional[int], scfg: tuple,
                           max_nodes: int, gbar: torch.Tensor):
    """The solve's backward: K6 for CUDA tensors, its plain version for CPU
    tensors.  Arguments and result as :func:`fused_solve_dopri5_bwd_reference`,
    the group being the batch's control group."""
    _device_check(u0, "fused_solve_dopri5_bwd")
    t0, t1 = _times(u0, tspan)
    return _bwd(u0, eps, ys, weights_of(params), t0, t1, nz, t_col, scfg, max_nodes, gbar,
                _group_of(u0))


class _FusedAdaptive(torch.autograd.Function):
    """K5 forward, K6 backward, with the cotangent structure of the JAX rule
    (``pallas_adaptive._fused_adaptive_bwd``): ``u0``, ``eps`` and the six
    weights get real cotangents, ``ys`` zeros, the time span none.  The
    stats rows are not differentiable.  K5's weight image (the cluster
    path's) is kept for K6, so it is built once a step; where the result
    will be taken back (``backward`` in ``static``: :func:`_wants_backward`)
    so is K5's record on the cluster path, which K6 walks and frees."""

    @staticmethod
    def forward(ctx, u0, eps, ys, t0, t1, static, *weights):
        nz, t_col, scfg, max_nodes, group, backward = static
        ctx.save_for_backward(u0, eps, ys, t0, t1, *weights)
        ctx.static = static
        ctx.image = ctx.record = None
        if u0.device.type == "cpu":
            u1, rows = _fwd_reference(u0, eps, ys, params_of(weights), t0, t1, nz, t_col,
                                      scfg, group)
        else:
            u1, rows, ctx.image, ctx.record = _launch_fwd(
                u0, eps, ys, weights, t0, t1, nz, t_col, scfg, group, max_nodes if backward else 0)
        ctx.mark_non_differentiable(rows)
        return u1, rows

    @staticmethod
    def backward(ctx, gbar, _grows):
        u0, eps, ys, t0, t1, *weights = ctx.saved_tensors
        nz, t_col, scfg, max_nodes, group, _backward = ctx.static
        record, ctx.record = ctx.record, None  # its memory goes with this backward
        u0bar, epsbar, wbars, _nacc = _bwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg,
                                           max_nodes, gbar, group, ctx.image, record)
        ysbar = None if ys is None else torch.zeros_like(ys)
        return (u0bar, epsbar, ysbar, None, None, None, *wbars)


def fused_solve_dopri5(u0: torch.Tensor, eps: torch.Tensor, ys: Optional[torch.Tensor],
                       params: Params, tspan, nz: int, t_col: Optional[int], scfg: tuple,
                       max_nodes: int):
    """Adaptive whole-solve forward, differentiable.  Arguments as
    :func:`.fused_solve.fused_solve_rk4` plus ``scfg`` (:func:`_scfg_tuple`)
    and ``max_nodes`` (the backward's node buffer).  Returns ``(u1,
    stats_rows)``; fold the rows with :func:`stats_from_rows`.  The batch
    must make whole control groups (:func:`fused_adaptive_tile`)."""
    _device_check(u0, "fused_solve_dopri5")
    group = _group_of(u0)
    t0, t1 = _times(u0, tspan)
    weights = weights_of(params)
    static = (nz, t_col, tuple(scfg), int(max_nodes), group, _wants_backward(u0, eps, weights))
    return _FusedAdaptive.apply(u0, eps, ys, t0, t1, static, *weights)
