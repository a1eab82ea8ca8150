"""Float64 through the port: the twin of ``tests/test_float64.py``.

``ICNFConfig(dtype=torch.float64)`` with float64 nets must deliver
float64-grade accuracy from the tolerance-critical machinery, at the JAX
package's float64 tolerances: the adaptive solvers' closed-form linear-flow
log-density to 1e-8 at rtol 1e-10, the two continuous adjoints' gradients
to 1e-7 of each other, a float64 rk4 train step (held against JAX's under
``jax.enable_x64`` at rtol 1e-9: the same float64 arithmetic, sums in
another order) and ``generate``, and the carried-start fit.  A float64
config with ``fused=True`` takes the unfused route (the kernels take
float32; JAX's gates stay closed off the TPU), so it gives ``fused=False``'s
bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu.config import ICNFConfig as JConfig
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.models.nets import MLP as JMLP
from continuousnormalizingflows_tpu_torch.config import ICNFConfig, Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.models.nets import MLP
from continuousnormalizingflows_tpu_torch.ops.dynamics import fused_dynamics_applicable
from continuousnormalizingflows_tpu_torch.ops.fused_adaptive import fused_adaptive_applicable
from continuousnormalizingflows_tpu_torch.ops.fused_solve import fused_solve_applicable
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

F64 = torch.float64


def _log_normal(z: torch.Tensor) -> torch.Tensor:
    d = z.shape[-1]
    return -0.5 * (d * np.log(2 * np.pi) + torch.sum(z * z, dim=-1))


@pytest.mark.parametrize("method,kw", [("dopri5", {}), ("tsit5", {}),
                                       ("abm", {"abm_order": 8})])
def test_linear_flow_logp_1e8(method, kw):
    """The closed-form linear-flow log-density to 1e-8 at rtol 1e-10: float32
    cannot reach it."""
    d = 3
    a = torch.tensor([[-0.3, 0.2, 0.0], [0.1, -0.4, 0.05], [0.0, 0.1, -0.2]], dtype=F64)
    cfg = ICNFConfig(nvariables=d, naugments=0, autonomous=True, lambda_1=0.0, lambda_2=0.0,
                     lambda_3=0.0, steer_rate=0.0, dtype=F64,
                     solver=SolverConfig(method=method, rtol=1e-10, atol=1e-10, **kw))
    icnf = tcnf.ICNF(cfg, MLP((d, d), dtype=F64))
    params = {"layers.0.weight": a, "layers.0.bias": torch.zeros(d, dtype=F64)}  # A x
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, d)) * 0.5)
    with torch.no_grad():
        lp, _augs, _st = tcnf.inference(icnf, Mode.TEST, x, params)
    assert lp.dtype == F64
    lp_true = _log_normal(x @ torch.linalg.matrix_exp(a).T) + torch.trace(a)  # z(1) = e^A x
    np.testing.assert_allclose(lp.numpy(), lp_true.numpy(), atol=1e-8)


def test_adjoint_vs_quadrature_grads_f64():
    """The backsolve and the quadrature adjoints agree to float64 precision
    on a smooth field (JAX measured 1.5e-8; float32's anchor is 2e-3)."""
    cfg_kw = dict(nvariables=2, naugments=0, lambda_3=0.0, steer_rate=0.0, dtype=F64)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(32, 2)) * 0.4)
    grads = {}
    for gradient in ("adjoint", "quadrature"):
        cfg = ICNFConfig(solver=SolverConfig(method="dopri5", rtol=1e-10, atol=1e-10,
                                             gradient=gradient), **cfg_kw)
        icnf = tcnf.ICNF(cfg, MLP((cfg.n_in, 16, 16, cfg.n_out), dtype=F64))
        params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
        params = {k: v.requires_grad_() for k, v in params.items()}
        tcnf.loss(icnf, Mode.TRAIN, x, params, torch.Generator().manual_seed(3)).backward()
        grads[gradient] = [p.grad for p in params.values()]
    for a, b in zip(grads["adjoint"], grads["quadrature"]):
        assert a.dtype == F64
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def _rk4_f64(fused=False):
    cfg = ICNFConfig(nvariables=2, dtype=F64, fused=fused,
                     solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=8))
    return tcnf.ICNF(cfg, MLP((cfg.n_in, 12, 12, cfg.n_out), dtype=F64))


def test_f64_training_step_and_generate(monkeypatch):
    """One float64 train step and ``generate``: the dtypes survive the whole
    loop, and the loss and gradients are JAX's float64 ones on the same
    params and draws."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 2))
    eps = rng.normal(size=(1, 16, 5))
    t1 = 1.03
    icnf = _rk4_f64()
    with jax.enable_x64(True):
        jcfg = JConfig(nvariables=2, dtype=jnp.float64,
                       solver=JSolver(method="rk4", gradient="backprop", fixed_steps=8))
        jicnf = jcnf.ICNF(config=jcfg, net=JMLP((jcfg.n_in, 12, 12, jcfg.n_out),
                                                 dtype=jnp.float64))
        jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
        monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
        monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float64(t1))
        l_j, g_j = jax.value_and_grad(lambda p: jcnf.loss(jicnf, JMode.TRAIN, jnp.asarray(x), p,
                                                          key=jax.random.PRNGKey(1)))(jparams)
        l_j, g_j = float(l_j), jax.device_get(g_j)
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams, dtype=F64).items()}
    assert all(v.dtype == F64 for v in params.values())
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1, dtype=F64))
    loss = tcnf.loss(icnf, Mode.TRAIN, torch.from_numpy(x), params,
                     torch.Generator().manual_seed(1))
    assert loss.dtype == F64
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), l_j, rtol=1e-9)
    for (k, p), want in zip(params.items(), params_from_jax(g_j, dtype=F64).values()):
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    torch.optim.Adam(list(params.values()), lr=1e-3).step()
    assert all(v.dtype == F64 for v in params.values())
    gen = tcnf.generate(icnf, Mode.TEST, {k: v.detach() for k, v in params.items()},
                        torch.Generator().manual_seed(5), 8)
    assert gen.dtype == F64 and bool(torch.all(torch.isfinite(gen)))


def test_float64_carry_fit():
    """``dt0="carry"`` with a float64 model through the steps-per-dispatch
    path: the carried step follows the state's dtype."""
    icnf = tcnf.ICNF.create(nvariables=2, dtype=F64, solver=SolverConfig(
        method="dopri5", rtol=1e-6, atol=1e-6, gradient="adjoint", dt0="carry"))
    assert all(v.dtype == F64 for v in icnf.init(torch.Generator().manual_seed(0),
                                                 device="cpu").values())
    x = np.random.default_rng(0).normal(size=(64, 2))
    m = tcnf.ICNFModel(icnf, batchsize=32, epochs=2, steps_per_dispatch=2, device="cpu",
                       optimizer=tcnf.default_optimizer(clip_norm=1.0))
    res = m.fit(x)
    assert np.isfinite(res.stats["final_loss"]) and res.stats["nfe"] > 0


FUSED_SOLVERS = {
    "rk4": dict(solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=8)),
    "default_stack": dict(solver=SolverConfig()),
    "fused_adaptive": dict(solver=SolverConfig(), fused_adaptive=True),
}


@pytest.mark.parametrize("name", list(FUSED_SOLVERS))
def test_float64_fused_takes_the_unfused_route(name):
    """A float64 config with ``fused=True`` closes the three fused gates (K3,
    K5 and K1's), so its loss, stats and gradients are ``fused=False``'s
    bits: float64 throughout, on the CPU as on the card."""
    kw = FUSED_SOLVERS[name]
    nets, cfgs = {}, {}
    for fused in (False, True):
        cfgs[fused] = ICNFConfig(nvariables=2, dtype=F64, fused=fused, **kw)
        nets[fused] = MLP((cfgs[fused].n_in, 12, 12, cfgs[fused].n_out), dtype=F64)
    cfg, net = cfgs[True], nets[True]
    assert not fused_solve_applicable(cfg, net, Mode.TRAIN)
    assert not fused_adaptive_applicable(cfg, net, Mode.TRAIN)
    assert not fused_dynamics_applicable(cfg, net, Mode.TRAIN)
    f32 = ICNFConfig(nvariables=2, fused=True, **kw)
    assert (fused_solve_applicable(f32, MLP((f32.n_in, 12, 12, f32.n_out)), Mode.TRAIN)
            or fused_dynamics_applicable(f32, MLP((f32.n_in, 12, 12, f32.n_out)), Mode.TRAIN))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(32, 2)) * 0.5)
    got = {}
    for fused in (False, True):
        icnf = tcnf.ICNF(cfgs[fused], nets[fused])
        params = {k: v.requires_grad_()
                  for k, v in icnf.init(torch.Generator().manual_seed(0), device="cpu").items()}
        loss, st = tcnf.loss_with_stats(icnf, Mode.TRAIN, x, params,
                                        torch.Generator().manual_seed(6))
        loss.backward()
        got[fused] = (loss.detach(), int(st.nfe), [p.grad for p in params.values()])
    assert got[True][0].dtype == F64 and torch.equal(got[True][0], got[False][0])
    assert got[True][1] == got[False][1]
    assert all(torch.equal(a, b) for a, b in zip(got[True][2], got[False][2]))
