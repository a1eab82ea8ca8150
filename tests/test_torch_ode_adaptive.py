"""The port's adaptive solvers against the JAX package's, on the flagship's
augmented dynamics (2-D RNODE, nz = 5, MLP 6 -> 24 -> 24 -> 5) at B = 16.

Both packages take the same params, states and probes (numpy, seeded).  The
step statistics (NFE, accepted, rejected) must be equal: the port runs the
same controller on the same global RMS norm.  A step sequence can still
part where a decision sits on a rounding edge: after the HNW start the
first trial's error ratio is ~1e-5, at float32 rounding level, so the next
step's size is partly noise, and where it ends just short of or past t1 the
two packages take one step more or less (seen once in 24 cases with seed 3,
TRAIN dopri5 forward).  The seed of the matrix below hits no such edge.
Values within rtol 2e-4 / atol 2e-5: an fp32 solve of a few steps, sums
taken in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.ops import ode as jode
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import ode as tode
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics as tdyn
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

B = 16
RTOL, ATOL = 2e-4, 2e-5


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _setup(mode, seed=0, **solver):
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver))
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    cfg = ticnf.config
    u0 = np.concatenate([rng.standard_normal((B, 2)), np.zeros((B, cfg.state_dim - 2))],
                        axis=-1).astype(np.float32)
    eps = rng.standard_normal((1, B, cfg.nz)).astype(np.float32) if mode.stochastic else None
    jargs = {"params": jparams, "eps": None if eps is None else jnp.asarray(eps), "ys": None}
    targs = {"params": params_from_jax(jparams),
             "eps": None if eps is None else torch.from_numpy(eps), "ys": None}
    jf = jdyn(jicnf.config, jicnf.net, JMode(mode.value))
    tf = tdyn(cfg, ticnf.net, mode)
    return jicnf, ticnf, u0, (jf, jargs), (tf, targs)


def _stats(s):
    return int(s.nfe), int(s.naccept), int(s.nreject)


@pytest.mark.parametrize("dt0", [0.05, "auto", "override"])
@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
@pytest.mark.parametrize("span", [(0.0, 1.0), (1.0, 0.0)], ids=["forward", "reversed"])
@pytest.mark.parametrize("mode", [Mode.TEST, Mode.TRAIN])
def test_odeint_matches_jax(mode, span, method, dt0):
    override = 0.03 if dt0 == "override" else None
    cfg_dt0 = "auto" if dt0 == "override" else dt0
    jicnf, ticnf, u0, (jf, jargs), (tf, targs) = _setup(mode, seed=1, method=method,
                                                         dt0=cfg_dt0)
    t0, t1 = span
    solve = jax.jit(lambda u: jode.odeint(
        jf, u, t0, t1, jargs, jicnf.config.solver,
        dt0_override=None if override is None else jnp.float32(override)))
    y_j, s_j = solve(jnp.asarray(u0))
    y_t, s_t = tode.odeint(tf, torch.from_numpy(u0), t0, t1, targs, ticnf.config.solver,
                           dt0_override=None if override is None else torch.tensor(override))
    assert _stats(s_t) == _stats(s_j)
    _close(y_t, y_j)


def test_carried_dt0_channel_and_its_fallback():
    """``args["dt0"]`` is the carry channel; a non-finite or zero carry falls
    back to the fixed-fraction start, as in JAX."""
    jicnf, ticnf, u0, (jf, jargs), (tf, targs) = _setup(Mode.TRAIN, dt0="carry")
    for carry in (0.2, 0.0, float("inf")):
        y_j, s_j = jax.jit(lambda u: jode.odeint(jf, u, 0.0, 1.0, {**jargs, "dt0": jnp.float32(carry)},
                                                 jicnf.config.solver))(jnp.asarray(u0))
        y_t, s_t = tode.odeint(tf, torch.from_numpy(u0), 0.0, 1.0,
                               {**targs, "dt0": torch.tensor(carry)}, ticnf.config.solver)
        assert _stats(s_t) == _stats(s_j)
        _close(y_t, y_j)


def test_max_steps_exhaustion_poisons():
    _j, ticnf, u0, _jf, (tf, targs) = _setup(Mode.TEST, rtol=1e-10, atol=1e-10, max_steps=3)
    y, s = tode.odeint(tf, torch.from_numpy(u0), 0.0, 1.0, targs, ticnf.config.solver)
    assert torch.isnan(y).all()
    assert s.naccept + s.nreject == 3


def test_non_finite_field_gives_up():
    """A field that is NaN everywhere: every trial is a reject at the
    smallest factor until the step is below 1e-6 of the span, then the solve
    stops early (far inside max_steps) and poisons."""
    cfg = SolverConfig()
    y, s = tode.odeint(lambda t, y, a: y * float("nan"), torch.ones(4, 3), 0.0, 1.0, None, cfg)
    jy, js = jax.jit(lambda y0: jode.odeint(lambda t, y, a: y * jnp.nan, y0, 0.0, 1.0, None,
                                            JSolver()))(jnp.ones((4, 3)))
    assert torch.isnan(y).all() and bool(jnp.all(jnp.isnan(jy)))
    assert s.naccept == 0 and s.nreject == int(js.nreject) < cfg.max_steps


def test_seminorm_error_weight_on_a_tuple_state():
    """A tuple state whose second leaf is pure quadrature: with the leaf out
    of the norm (error_weight) the solve takes the steps of the first leaf
    alone, in both packages."""
    lam = np.linspace(0.5, 3.0, 6).astype(np.float32)

    def jf(t, y, _a):
        x, _q = y
        return (-jnp.asarray(lam) * x, 10.0 * jnp.cos(10.0 * t) * x)

    def tf(t, y, _a):
        x, _q = y
        return (-torch.from_numpy(lam) * x, 10.0 * torch.cos(10.0 * t) * x)

    y0 = (np.ones(6, np.float32), np.zeros(6, np.float32))
    for weight in (None, (True, False)):
        yj, sj = jax.jit(lambda a, b: jode.odeint(jf, (a, b), 0.0, 1.0, None, JSolver(),
                                                  weight))(*map(jnp.asarray, y0))
        yt, st = tode.odeint(tf, tuple(map(torch.from_numpy, y0)), 0.0, 1.0, None,
                             SolverConfig(), weight)
        assert _stats(st) == _stats(sj)
        for a, b in zip(yt, yj):
            _close(a, b)
    assert _stats(st) != tode.odeint(tf, tuple(map(torch.from_numpy, y0)), 0.0, 1.0, None,
                                     SolverConfig())[1][:3]


@pytest.mark.parametrize("span", [(0.0, 1.0), (1.0, 0.0)], ids=["forward", "reversed"])
def test_dense_output_matches_jax(span):
    jicnf, ticnf, u0, (jf, jargs), (tf, targs) = _setup(Mode.TEST)
    t0, t1 = span
    y_j, s_j, d_j = jax.jit(lambda u: jode.odeint_dense(jf, u, t0, t1, jargs,
                                                        jicnf.config.solver))(jnp.asarray(u0))
    y_t, s_t, d_t = tode.odeint_dense(tf, torch.from_numpy(u0), t0, t1, targs,
                                      ticnf.config.solver)
    assert _stats(s_t) == _stats(s_j) and d_t.n == int(d_j.n)
    _close(y_t, y_j)
    # the plain solve takes the same steps to the same end state
    y_p, s_p = tode.odeint(tf, torch.from_numpy(u0), t0, t1, targs, ticnf.config.solver)
    assert _stats(s_p) == _stats(s_t) and torch.equal(y_p, y_t)
    for t in (0.0, 0.13, 0.5, 0.77, 1.0, 1.4):
        _close(tode.eval_dense(d_t, t), jode.eval_dense(d_j, jnp.float32(t)))


def test_dense_node_overflow_poisons():
    _j, ticnf, u0, _jf, (tf, targs) = _setup(Mode.TEST, rtol=1e-6, atol=1e-6, dense_max_nodes=3)
    y, s, dense = tode.odeint_dense(tf, torch.from_numpy(u0), 0.0, 1.0, targs,
                                    ticnf.config.solver)
    assert s.naccept > 2 and dense.n == 3
    assert torch.isnan(y).all() and torch.isnan(dense.ys).all()


@pytest.mark.parametrize("solver", [dict(), dict(method="tsit5"),
                                    dict(method="rk4", gradient="backprop")],
                         ids=["dopri5", "tsit5", "rk4"])
def test_trajectory_matches_jax(solver):
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver))
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(3).standard_normal((B, 2)).astype(np.float32)
    ts = np.array([0.0, 0.2, 0.45, 0.9, 1.0], np.float32)
    p_j, s_j = jcore.trajectory(jicnf, x, jparams, ts)
    p_t, s_t = tcnf.trajectory(ticnf, x, params_from_jax(jparams), ts)
    assert p_t.shape == (len(ts), B, 5)
    assert _stats(s_t) == _stats(s_j)
    _close(p_t, p_j)


def test_abm_still_raises():
    """``method="abm"`` no longer raises: both forms dispatch to the
    multistep solver (held against JAX in test_torch_ode_abm.py); dense
    output of a fixed-step method still raises."""
    _j, ticnf, u0, _jf, (tf, targs) = _setup(Mode.TEST, method="abm")
    y, s = tode.odeint(tf, torch.from_numpy(u0), 0.0, 1.0, targs, ticnf.config.solver)
    y_d, s_d, dense = tode.odeint_dense(tf, torch.from_numpy(u0), 0.0, 1.0, targs,
                                        ticnf.config.solver)
    assert torch.isfinite(y).all() and torch.equal(y, y_d) and _stats(s) == _stats(s_d)
    assert s.nfe == 1 + 2 * (s.naccept + s.nreject) and dense.n == s.naccept + 1
    rk4 = dataclasses.replace(ticnf.config.solver, method="rk4", gradient="adjoint")
    with pytest.raises(ValueError, match="dense output"):
        tode.odeint_dense(tf, torch.from_numpy(u0), 0.0, 1.0, targs, rk4)


# t0 + (t1 - t0) rounds past t1 in float32 for these two (about one last step
# in seven that starts below t1 / 2 does so)
_PAST_T0, _PAST_T1 = np.float32(0.2902631461620331), np.float32(0.905047)


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "abm"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_a_landing_that_rounds_past_t1_ends_the_solve(method, reverse):
    """The step clamped to t1 - t whose landing rounds past t1 lands on t1
    and ends the solve (``ops/ode._land``).  Past t1 the done test (within
    1e-12) never held and each next step, direction * |t1 - t|, moved away:
    on the card the unfused band step of ``chip_smoke.py`` ran to t = 100
    and overflowed.  A constant field: every trial is accepted."""
    t0, t1 = (_PAST_T0, _PAST_T1) if not reverse else (-_PAST_T0, -_PAST_T1)
    assert abs(np.float32(t0 + np.float32(t1 - t0))) > abs(t1)
    cfg = SolverConfig(method=method, dt0=1.0, max_steps=8)
    y1, st = tode.odeint(lambda t, y, args: torch.ones_like(y), torch.zeros(4),
                         torch.tensor(t0), torch.tensor(t1), None, cfg)
    assert torch.isfinite(y1).all() and int(st.naccept) == 1 and int(st.nreject) == 0
    torch.testing.assert_close(y1, torch.full((4,), float(t1 - t0)), rtol=1e-6, atol=1e-6)
