"""The port's continuous adjoints against the JAX package's ``odeint_diff``,
on the flagship's augmented dynamics (2-D RNODE, nz = 5, MLP 6 -> 24 -> 24
-> 5) at B = 16, and the loss gradients of the default-config ICNF (dopri5,
rtol = atol = 1e-4, backsolve adjoint) with the probe and the steered end
time injected into both packages.

Gradients are held per tensor as ``max|port - jax| <= 2e-4 * max|jax|``:
both backward passes are adaptive float32 solves of the same adjoint system
that take the same steps, with sums in another order; a weight gradient
sums over every row and step, so its small entries carry the absolute error
of its largest (measured: under 1e-6 of the largest)."""

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
from continuousnormalizingflows_tpu.ops.adjoint import odeint_diff as jdiff
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops.adjoint import odeint_diff as tdiff
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics as tdyn
from continuousnormalizingflows_tpu_torch.ops.ode import odeint as todeint
from continuousnormalizingflows_tpu_torch.utils import profiling
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

B = 16
GRAD_TOL = 2e-4


def _close_to_max(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), (
        np.max(np.abs(got - want)), np.max(np.abs(want)))


def _grads_close(t_grads: dict, j_grads):
    for (k, a), b in zip(t_grads.items(), params_from_jax(jax.device_get(j_grads)).values()):
        _close_to_max(a, b)


def _setup(solver, fused=False):
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver))
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), fused=fused)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    u0 = np.concatenate([rng.standard_normal((B, 2)), np.zeros((B, 6))], -1).astype(np.float32)
    eps = rng.standard_normal((1, B, 5)).astype(np.float32)
    return jicnf, ticnf, jparams, u0, eps


SOLVERS = {
    "backsolve": dict(),
    "quadrature": dict(gradient="quadrature"),
    "tsit5-backsolve": dict(method="tsit5", dt0=0.05),
    "rk4-backsolve": dict(method="rk4", gradient="adjoint", fixed_steps=8),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_odeint_diff_grads_match_jax(name):
    """d/d(u0, params, t1) of a weighted sum of u1, TRAIN mode."""
    jicnf, ticnf, jparams, u0, eps = _setup(SOLVERS[name])
    w = np.arange(1.0, 9.0, dtype=np.float32)
    jf = jdyn(jicnf.config, jicnf.net, JMode.TRAIN)

    def jloss(u, p, t1):
        u1, _ = jdiff(jf, u, 0.0, t1, {"params": p, "eps": jnp.asarray(eps), "ys": None},
                      jicnf.config.solver)
        return jnp.sum(u1 * w)

    gu_j, gp_j, gt_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(u0), jparams, jnp.float32(1.05))
    tf = tdyn(ticnf.config, ticnf.net, Mode.TRAIN)
    u = torch.from_numpy(u0).requires_grad_()
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    t1 = torch.tensor(1.05, requires_grad=True)
    u1, stats = tdiff(tf, u, 0.0, t1, {"params": p, "eps": torch.from_numpy(eps), "ys": None},
                      ticnf.config.solver)
    gu_t, gt_t, *gp_t = torch.autograd.grad(torch.sum(u1 * torch.from_numpy(w)),
                                            [u, t1, *p.values()])
    _close_to_max(gu_t, gu_j)
    _close_to_max(gt_t, gt_j)
    _grads_close(dict(zip(p, gp_t)), gp_j)
    # the forward of the differentiable solve is the plain solve
    with torch.no_grad():
        y, s = todeint(tf, torch.from_numpy(u0), 0.0, torch.tensor(1.05),
                       {"params": p, "eps": torch.from_numpy(eps), "ys": None},
                       ticnf.config.solver)
    assert torch.equal(y, u1.detach()) and tuple(s[:3]) == tuple(stats[:3])


@pytest.fixture
def same_draws(monkeypatch):
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((1, B, 5)).astype(np.float32)
    t1 = np.float32(0.95)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))


def _loss_and_grads(jicnf, ticnf, jparams, x, mode, dt0=None):
    l_j, g_j = jax.value_and_grad(lambda p: jcnf.loss(
        jicnf, JMode(mode.value), x, p, key=jax.random.PRNGKey(0),
        dt0=None if dt0 is None else jnp.float32(dt0)))(jparams)
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    l_t = tcnf.loss(ticnf, mode, x, p, torch.Generator().manual_seed(0),
                    dt0=None if dt0 is None else torch.tensor(dt0))
    g_t = dict(zip(p, torch.autograd.grad(l_t, list(p.values()))))
    return float(l_j), g_j, float(l_t.detach()), g_t


@pytest.mark.parametrize("mode", [Mode.TEST, Mode.TRAIN, Mode.TRAIN_NOREG])
@pytest.mark.parametrize("gradient", ["adjoint", "quadrature"])
def test_default_config_loss_grads_match_jax(same_draws, gradient, mode):
    jicnf, ticnf, jparams, u0, _eps = _setup(dict(gradient=gradient))
    assert ticnf.config.solver.method == "dopri5" and ticnf.config.solver.dt0 == "auto"
    l_j, g_j, l_t, g_t = _loss_and_grads(jicnf, ticnf, jparams, u0[:, :2], mode)
    np.testing.assert_allclose(l_t, l_j, rtol=2e-5, atol=2e-4)
    _grads_close(g_t, g_j)


def test_carried_start_reaches_both_solves(same_draws):
    """``dt0=`` (the carry) starts the forward and the backward solve."""
    jicnf, ticnf, jparams, u0, _eps = _setup(dict(dt0="carry"))
    for dt0 in (0.3, 0.0):
        l_j, g_j, l_t, g_t = _loss_and_grads(jicnf, ticnf, jparams, u0[:, :2], Mode.TRAIN, dt0)
        np.testing.assert_allclose(l_t, l_j, rtol=2e-5, atol=2e-4)
        _grads_close(g_t, g_j)


def test_fused_stage_carries_the_adjoint(same_draws):
    """With ``fused=True`` the forward's stages are K1 and the backward's
    per-evaluation VJP runs through K2 (their plain versions on the CPU):
    the same gradients as the JAX package's unfused adjoint."""
    jicnf, ticnf, jparams, u0, _eps = _setup(dict(), fused=True)
    counts = profiling.counters().get("K1.launches", 0)
    l_j, g_j, l_t, g_t = _loss_and_grads(jicnf, ticnf, jparams, u0[:, :2], Mode.TRAIN_NOREG)
    assert profiling.counters().get("K1.launches", 0) == counts  # CPU tensors: no kernel
    np.testing.assert_allclose(l_t, l_j, rtol=2e-5, atol=2e-4)
    _grads_close(g_t, g_j)


def test_probe_gets_no_cotangent_and_no_grad_is_plain():
    jicnf, ticnf, jparams, u0, eps = _setup(dict())
    tf = tdyn(ticnf.config, ticnf.net, Mode.TRAIN)
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    e = torch.from_numpy(eps).requires_grad_()
    u1, _ = tdiff(tf, torch.from_numpy(u0), 0.0, 1.0, {"params": p, "eps": e, "ys": None},
                  ticnf.config.solver)
    ge, gw = torch.autograd.grad(u1.sum(), [e, p["layers.0.weight"]], allow_unused=True)
    assert ge is None and torch.isfinite(gw).all()
    with torch.no_grad():
        u1n, _ = tdiff(tf, torch.from_numpy(u0), 0.0, 1.0, {"params": p, "eps": e, "ys": None},
                       ticnf.config.solver)
    assert not u1n.requires_grad and torch.equal(u1n, u1.detach())
