"""The port's remaining trace estimators against the JAX package's: the
planar net's analytic trace (with its exact Frobenius ``reg_j``), the
generic exact sweep (unchunked and in blocks of ``exact_chunk`` rows, with
and without the Frobenius sum) and the Hutchinson JVP.

Each ``f_aug`` is held against JAX's on the same state, params (crossed by
``utils.convert``) and probes at rtol 1e-5 / atol 1e-6, and the loss
gradients through each against ``jax.grad`` with the probe and the steered
end time injected: under the backsolve adjoint (dopri5 at 1e-4) and under
rk4 backprop with ``remat=True`` (a non-reentrant checkpoint a step), per
tensor within 2e-4 of its largest entry."""

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
from continuousnormalizingflows_tpu.config import ICNFConfig as JConfig
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.config import TraceEstimator as JTrace
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
from continuousnormalizingflows_tpu_torch.config import ICNFConfig, Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.config import TraceEstimator
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics as tdyn
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_field
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

B = 8
GRAD_TOL = 2e-4

# name -> (config kwargs, net: "planar" | hidden widths of an MLP)
CASES = {
    "planar": (dict(nvariables=2, trace="exact"), "planar"),
    "sweep": (dict(nvariables=6, naugments=0, lambda_3=0.0, trace="exact"), (16, 16, 16)),
    "sweep-chunk4": (dict(nvariables=6, naugments=0, lambda_3=0.0, trace="exact",
                          exact_chunk=4), (16, 16, 16)),
    "jvp": (dict(nvariables=2, trace="hutch_jvp"), None),
}


def _models(name, solver=None):
    kw, net = CASES[name]
    solver = solver or {}
    jcfg = JConfig(**{**kw, "trace": JTrace(kw["trace"])}, solver=JSolver(**solver))
    tcfg = ICNFConfig(**{**kw, "trace": TraceEstimator(kw["trace"])},
                      solver=SolverConfig(**solver))
    if net == "planar":
        jnet, tnet = jcnf.Planar(jcfg.n_in, jcfg.n_out), tcnf.Planar(tcfg.n_in, tcfg.n_out)
    elif net is None:
        jnet = tnet = None
    else:
        widths = (tcfg.n_in,) + net + (tcfg.n_out,)
        jnet, tnet = jcnf.MLP(widths), tcnf.MLP(widths)
    jicnf = jcnf.ICNF(config=jcfg, net=jnet) if jnet else jcnf.ICNF.create(
        **{**kw, "trace": JTrace(kw["trace"])}, solver=JSolver(**solver))
    ticnf = tcnf.ICNF(config=tcfg, net=tnet) if tnet else tcnf.ICNF.create(
        **{**kw, "trace": TraceEstimator(kw["trace"])}, solver=SolverConfig(**solver))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(3)))
    return jicnf, ticnf, jparams


def _close_to_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.all(np.isfinite(a))
    assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), (np.abs(a - b).max(),
                                                               np.abs(b).max())


@pytest.mark.parametrize("mode", [Mode.TEST, Mode.TRAIN, Mode.TRAIN_NOREG])
@pytest.mark.parametrize("name", list(CASES))
def test_f_aug_matches_jax(name, mode):
    jicnf, ticnf, jparams = _models(name)
    cfg = ticnf.config
    rng = np.random.default_rng(4)
    u = rng.standard_normal((B, cfg.state_dim)).astype(np.float32)
    eps = rng.standard_normal((1, B, cfg.nz)).astype(np.float32)
    du_j = jax.jit(lambda uu: jdyn(jicnf.config, jicnf.net, JMode(mode.value))(
        0.3, uu, {"params": jparams, "eps": jnp.asarray(eps), "ys": None}))(jnp.asarray(u))
    du_t = tdyn(cfg, ticnf.net, mode)(0.3, torch.from_numpy(u), {
        "params": params_from_jax(jparams), "eps": torch.from_numpy(eps), "ys": None})
    np.testing.assert_allclose(du_t.numpy(), np.asarray(du_j), rtol=1e-5, atol=1e-6)
    if mode is Mode.TRAIN and name != "jvp":
        assert float(du_t[:, -1].abs().min()) > 1e-3  # the exact Frobenius reg_j is live


@pytest.mark.parametrize("solver", [
    dict(),
    dict(method="rk4", gradient="backprop", fixed_steps=8, remat=True),
], ids=["backsolve", "rk4-remat"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_gradients_match_jax(monkeypatch, name, solver):
    jicnf, ticnf, jparams = _models(name, solver)
    nz = ticnf.config.nz
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((1, B, nz)).astype(np.float32)
    x = rng.standard_normal((B, ticnf.config.nvariables)).astype(np.float32)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(0.95))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(0.95))
    l_j, g_j = jax.value_and_grad(lambda p: jcnf.loss(
        jicnf, JMode.TRAIN, x, p, key=jax.random.PRNGKey(0)))(jparams)
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    l_t = tcnf.loss(ticnf, Mode.TRAIN, x, p, torch.Generator().manual_seed(0))
    g_t = torch.autograd.grad(l_t, list(p.values()))
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=2e-5, atol=2e-4)
    for a, b in zip(g_t, params_from_jax(jax.device_get(g_j)).values()):
        _close_to_max(a, b)


def _jacobians(cfg, net, params, t, z):
    field = make_field(cfg, net)
    return torch.stack([torch.autograd.functional.jacobian(
        lambda zi: field(t, zi[None], params, None)[0], zi) for zi in z])


def test_planar_trace_and_frobenius_equal_the_jacobian():
    """The planar analytic trace and its Frobenius ``reg_j`` against the
    brute-force Jacobian (the JAX package's checks, on the port)."""
    cfg = ICNFConfig(nvariables=2, trace="exact")
    net = tcnf.Planar(cfg.n_in, cfg.n_out)
    params = net.init(torch.Generator().manual_seed(3), device="cpu")
    u = torch.randn((5, cfg.state_dim), generator=torch.Generator().manual_seed(1))
    du = tdyn(cfg, net, Mode.TRAIN)(0.3, u, {"params": params, "eps": None, "ys": None})
    jac = _jacobians(cfg, net, params, 0.3, u[:, :cfg.nz])
    np.testing.assert_allclose(du[:, cfg.nz].numpy(),
                               -torch.einsum("bii->b", jac).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(du[:, cfg.nz + 2].numpy(),
                               torch.sqrt((jac ** 2).sum((1, 2))).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 4, 7, 64])
def test_chunked_sweep_matches_the_full_sweep(chunk):
    """Blocks of ``exact_chunk`` basis rows (the last one overrun and masked)
    give the full sweep's trace and Frobenius sum (the JAX package's check,
    on the port), and both equal the brute-force Jacobian."""
    cfg = ICNFConfig(nvariables=6, naugments=0, lambda_3=0.0, trace="exact")
    net = tcnf.MLP((cfg.n_in, 32, 32, 32, cfg.n_out))
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    u = torch.randn((8, cfg.state_dim), generator=torch.Generator().manual_seed(1))
    args = {"params": params, "eps": None, "ys": None}
    chunked = dataclasses.replace(cfg, exact_chunk=chunk)
    for mode in (Mode.TEST, Mode.TRAIN):
        du_f = tdyn(cfg, net, mode)(0.3, u, args)
        du_c = tdyn(chunked, net, mode)(0.3, u, args)
        np.testing.assert_allclose(du_c.numpy(), du_f.numpy(), rtol=1e-5, atol=1e-6)
    jac = _jacobians(cfg, net, params, 0.3, u[:, :cfg.nz])
    np.testing.assert_allclose(du_f[:, cfg.nz].numpy(), -torch.einsum("bii->b", jac).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(du_f[:, -1].numpy(), torch.sqrt((jac ** 2).sum((1, 2))).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_vjp_and_jvp_give_one_contraction():
    """``eps^T (J eps) == (eps^T J) eps`` for the same probe (the JAX
    package's check, on the port)."""
    outs = []
    eps = torch.randn((1, 4, 5), generator=torch.Generator().manual_seed(2))
    u = torch.randn((4, 8), generator=torch.Generator().manual_seed(1))
    for trace in (TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP):
        icnf = tcnf.ICNF.create(nvariables=2, trace=trace)
        params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
        outs.append(tdyn(icnf.config, icnf.net, Mode.TRAIN)(
            0.5, u, {"params": params, "eps": eps, "ys": None}))
    # every column but reg_j, which is |eps^T J| in one and |J eps| in the other
    np.testing.assert_allclose(outs[0][:, :-1].numpy(), outs[1][:, :-1].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("planar", [False, True], ids=["mlp", "planar"])
@pytest.mark.parametrize("conditioned", [False, True], ids=["plain", "conditioned"])
@pytest.mark.parametrize("trace", [TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP],
                         ids=["vjp", "jvp"])
@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST], ids=["train", "test"])
def test_variant_lattice(mode, trace, conditioned, planar):
    """inference, generate, loss and gradients w.r.t. params and inputs are
    finite across estimators, conditioning and the planar net (the JAX
    package's smoke sweep, 4 samples x 2 dims, on the port)."""
    ncond = 2 if conditioned else 0
    cfg = ICNFConfig(nvariables=2, trace=trace, nconditions=ncond)
    net = tcnf.Planar(cfg.n_in, cfg.n_out) if planar else None
    icnf = tcnf.ICNF(config=cfg, net=net) if planar else tcnf.ICNF.create(
        nvariables=2, trace=trace, nconditions=ncond)
    gen = lambda s: torch.Generator().manual_seed(s)
    params = icnf.init(gen(0), device="cpu")
    x = 0.5 * torch.randn((4, 2), generator=gen(1))
    ys = torch.ones((4, ncond)) if conditioned else None
    lp, (e, n, a), _st = tcnf.inference(icnf, mode, x, params, gen(2), ys=ys)
    assert lp.shape == (4,) and torch.isfinite(lp).all()
    for acc in (e, n, a):
        assert acc.shape == (4,) and torch.isfinite(acc).all()
    if mode is Mode.TEST:
        assert (e == 0).all() and (n == 0).all() and (a == 0).all()
    samples = tcnf.generate(icnf, mode, params, gen(3), 3, ys=ys[:3] if conditioned else None)
    assert samples.shape == (3, 2) and torch.isfinite(samples).all()
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    gp = torch.autograd.grad(tcnf.loss(icnf, mode, xx, p, gen(2), ys=ys), [*p.values(), xx])
    assert all(torch.isfinite(g).all() for g in gp)
    assert sum(float(g.abs().sum()) for g in gp[:-1]) > 0


def test_exact_and_hutchinson_agree_with_many_probes():
    """TEST (exact) and TRAIN (Hutchinson, 512 probes, no regularization, no
    steer) log-densities agree (the JAX package's check, on the port)."""
    icnf = tcnf.ICNF.create(nvariables=2, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0,
                            steer_rate=0.0, nprobes=512,
                            solver=SolverConfig(rtol=1e-5, atol=1e-5))
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    x = 0.5 * torch.randn((8, 2), generator=torch.Generator().manual_seed(1))
    lp_exact = tcnf.inference(icnf, Mode.TEST, x, params)[0]
    for trace in (TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP):
        model = tcnf.ICNF(config=dataclasses.replace(icnf.config, trace=trace), net=icnf.net)
        lp = tcnf.inference(model, Mode.TRAIN, x, params, torch.Generator().manual_seed(2))[0]
        np.testing.assert_allclose(lp.numpy(), lp_exact.numpy(), rtol=0.05, atol=0.1)
