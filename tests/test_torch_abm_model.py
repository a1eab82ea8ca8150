"""The reference's default stack, ``method="abm"`` with ``gradient=
"quadrature"`` (VCABM with ``QuadratureAdjoint``), on the full flagship
model (2-D RNODE, MLP 6 -> 24 -> 24 -> 5) through the port's public entry
points: the loss and its gradients against ``jax.grad`` with the probe and
the steered end time injected into both packages, ``trajectory`` over the
abm dense output, and the JAX package's own full-model abm checks.

Gradients are held per tensor as ``max|port - jax| <= 2e-4 * max|jax|``
(both backward passes are adaptive float32 solves of one adjoint system on
the same steps, sums in another order)."""

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
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.utils import profiling
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

B = 16
GRAD_TOL = 2e-4


def _grads_close(t_grads: dict, j_grads):
    for a, b in zip(t_grads.values(), params_from_jax(jax.device_get(j_grads)).values()):
        a, b = a.numpy(), b.numpy()
        assert np.all(np.isfinite(a))
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), (np.abs(a - b).max(),
                                                                     np.abs(b).max())


@pytest.fixture
def same_draws(monkeypatch):
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((1, B, 5)).astype(np.float32)
    t1 = np.float32(0.95)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))


def _models(solver, fused=False):
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver))
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), fused=fused)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(2).standard_normal((B, 2)).astype(np.float32)
    return jicnf, ticnf, jparams, x


@pytest.mark.parametrize("gradient, fused", [("quadrature", False), ("quadrature", True),
                                             ("adjoint", False)],
                         ids=["quadrature", "quadrature-fused", "backsolve"])
def test_abm_loss_grads_match_jax(same_draws, gradient, fused):
    """TRAIN loss and its gradients; with ``fused=True`` every forward
    evaluation is the K1 stage and every VJP of the adjoint K2 (their plain
    versions on the CPU).  The forward solve takes JAX's steps."""
    solver = dict(method="abm", gradient=gradient)
    jicnf, ticnf, jparams, x = _models(solver, fused)
    (l_j, st_j), g_j = jax.value_and_grad(lambda p: jcnf.loss_with_stats(
        jicnf, JMode.TRAIN, x, p, key=jax.random.PRNGKey(0)), has_aux=True)(jparams)
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    counts = profiling.counters().get("K1.launches", 0)
    l_t, st_t = tcnf.loss_with_stats(ticnf, Mode.TRAIN, x, p, torch.Generator().manual_seed(0))
    g_t = dict(zip(p, torch.autograd.grad(l_t, list(p.values()))))
    assert profiling.counters().get("K1.launches", 0) == counts  # CPU tensors: the plain versions
    assert tuple(int(v) for v in st_t[:3]) == tuple(int(v) for v in st_j[:3])
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=2e-5, atol=2e-4)
    _grads_close(g_t, g_j)


@pytest.mark.parametrize("mode", [Mode.TEST, Mode.TRAIN_NOREG])
def test_abm_inference_matches_jax(same_draws, mode):
    jicnf, ticnf, jparams, x = _models(dict(method="abm", gradient="quadrature",
                                            abm_order=8, rtol=1e-5, atol=1e-5))
    lp_j, augs_j, st_j = jcnf.inference(jicnf, JMode(mode.value), x, jparams,
                                        key=jax.random.PRNGKey(0))
    lp_t, augs_t, st_t = tcnf.inference(ticnf, mode, x, params_from_jax(jparams),
                                        torch.Generator().manual_seed(0))
    assert tuple(int(v) for v in st_t[:3]) == tuple(int(v) for v in st_j[:3])
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-5)


def test_trajectory_over_abm_dense_output_matches_jax():
    jicnf, ticnf, jparams, x = _models(dict(method="abm", gradient="quadrature"))
    ts = np.array([0.0, 0.2, 0.45, 0.9, 1.0], np.float32)
    p_j, s_j = jcore.trajectory(jicnf, x, jparams, ts)
    p_t, s_t = tcnf.trajectory(ticnf, x, params_from_jax(jparams), ts)
    assert p_t.shape == (len(ts), B, 5)
    assert tuple(int(v) for v in s_t[:3]) == tuple(int(v) for v in s_j[:3])
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(p_t[0, :, :2].numpy(), x, rtol=1e-6, atol=1e-6)


def test_abm_quadrature_matches_rk4_backprop_gradients():
    """abm + quadrature (order 6, 1e-6) against discretize-then-optimize
    (rk4-64 backprop): the loss gradients within 2e-3, steer off (the JAX
    package's full-model check, on the port)."""
    x = 0.5 * torch.randn((8, 2), generator=torch.Generator().manual_seed(1))
    grads = {}
    for name, solver in (("q", SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                                            gradient="quadrature", abm_order=6)),
                         ("bp", SolverConfig(method="rk4", gradient="backprop",
                                             fixed_steps=64))):
        icnf = tcnf.ICNF.create(nvariables=2, solver=solver, steer_rate=0.0)
        p = {k: v.requires_grad_() for k, v in
             icnf.init(torch.Generator().manual_seed(7), device="cpu").items()}
        l = tcnf.loss(icnf, Mode.TRAIN, x, p, torch.Generator().manual_seed(0))
        grads[name] = torch.autograd.grad(l, list(p.values()))
    for a, b in zip(grads["q"], grads["bp"]):
        assert float((a - b).abs().max()) < 2e-3


def test_abm_log_densities_match_dopri5_at_lower_nfe():
    """TEST log-densities of abm and dopri5 from the same fixed start agree
    within 2e-3, abm at a lower NFE (the JAX package's check, on the port)."""
    icnf_dp = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(method="dopri5", dt0=0.01))
    icnf_abm = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(method="abm", dt0=0.01))
    params = icnf_dp.init(torch.Generator().manual_seed(0), device="cpu")
    x = 0.5 * torch.randn((16, 2), generator=torch.Generator().manual_seed(1))
    lp_dp, _, st_dp = tcnf.inference(icnf_dp, Mode.TEST, x, params)
    lp_abm, _, st_abm = tcnf.inference(icnf_abm, Mode.TEST, x, params)
    np.testing.assert_allclose(lp_abm.numpy(), lp_dp.numpy(), rtol=2e-3, atol=2e-3)
    assert st_abm.nfe < st_dp.nfe, (st_abm.nfe, st_dp.nfe)


def test_fit_over_abm_keeps_the_fixed_start():
    """``fit`` with abm + quadrature runs, and ``dt0="carry"`` carries
    nothing into an abm solve (its start is the fixed fraction)."""
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(
        method="abm", gradient="quadrature", dt0="carry"))
    model = tcnf.ICNFModel(icnf, batchsize=32, epochs=2, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    assert not model._carry_dt(32)
    x = torch.randn((64, 2), generator=torch.Generator().manual_seed(4))
    res = model.fit(x)
    assert res.stats["iterations"] == 4 and all(np.isfinite(res.history))
    assert res.stats["nfe"] == 1 + 2 * (res.stats["naccept"] + res.stats["nreject"])
