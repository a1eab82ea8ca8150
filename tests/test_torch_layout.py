"""``layout="feature_first"`` in the port against the JAX package's
``feature_first`` and against the port's own ``batch_first``: the state
inside a solve is ``(state_dim, batch)``, the probes ``(P, nz, batch)``,
the conditions ``(nconditions, batch)``, transposed once in and once out;
the public API stays batch-first.

Parameters cross with ``utils.convert``; the probe, the steered end time
and the base draw are injected into both packages.  Tolerances: JAX's own
layout test's (``tests/test_core.py::test_feature_first_layout_parity``):
losses 1e-4 absolute, gradients 1e-3 absolute, samples 1e-4 absolute;
the dynamics at one state rtol 1e-5 / atol 1e-6 (fp32, sums in another
order); ``trajectory`` in the two layouts rtol 1e-5 / atol 1e-6 (JAX's
``test_trajectory_feature_first_layout``), against JAX rtol 2e-4 / atol
2e-5 (``tests/test_torch_ode_adaptive.py``'s); the adaptive solves take equal
NFE, accepted and rejected steps in every layout and package; ``fit`` after
3 steps as ``tests/test_torch_train.py`` (params rtol 1e-4 / atol 1e-6,
losses rtol 1e-5); the exported log-density against the eager call at
rtol 1e-5 with equal steps."""

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
from continuousnormalizingflows_tpu.config import TraceEstimator as JTrace
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
from continuousnormalizingflows_tpu.utils import datasets as jdata
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig, TraceEstimator
from continuousnormalizingflows_tpu_torch.ops import dynamics as tdyn
from continuousnormalizingflows_tpu_torch.ops import fused_adaptive, fused_dynamics, fused_solve
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax

FIXED = dict(method="rk4", gradient="backprop", fixed_steps=16)  # JAX's FAST_FIXED
LAYOUTS = ("batch_first", "feature_first")
B = 8


def _pair(solver=FIXED, planar=False, hidden=None, **kw):
    """The same model in both packages: the default net, a planar net, or
    an MLP of ``hidden`` widths; the port's params are JAX's converted."""
    jcfg = jcnf.ICNFConfig(nvariables=2, solver=JSolver(**solver), **kw)
    tkw = {k: (TraceEstimator(v.value) if isinstance(v, JTrace) else v) for k, v in kw.items()}
    tcfg = tcnf.ICNFConfig(nvariables=2, solver=SolverConfig(**solver), **tkw)
    if planar:
        jnet, tnet = jcnf.Planar(jcfg.n_in, jcfg.n_out), tcnf.Planar(tcfg.n_in, tcfg.n_out)
    elif hidden is not None:
        widths = (tcfg.n_in,) + tuple(hidden) + (tcfg.n_out,)
        jnet, tnet = jcnf.MLP(widths), tcnf.MLP(widths)
    else:
        jnet = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver), **kw).net
        tnet = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), **tkw).net
    jicnf, ticnf = jcnf.ICNF(config=jcfg, net=jnet), tcnf.ICNF(config=tcfg, net=tnet)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(7)))
    return jicnf, jparams, ticnf, params_from_jax(jparams)


def _layout(icnf, layout):
    return dataclasses.replace(icnf, config=dataclasses.replace(icnf.config, layout=layout))


def _leaves(params):
    """A port parameter dict's leaves in the order of JAX's tree."""
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(params_to_jax(params))]


def _jleaves(params):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(params)]


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages' probe, steer and base samplers return the same arrays."""
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((2, 64, 5)).astype(np.float32)
    z1 = rng.standard_normal((64, 5)).astype(np.float32)
    t1 = np.float32(1.05)
    monkeypatch.setattr(jcore, "sample_probe",
                        lambda cfg, key, b: jnp.asarray(eps[:cfg.nprobes, :b, :cfg.nz]))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(jcore, "sample_base", lambda cfg, key, n: jnp.asarray(z1[:n, :cfg.nz]))
    monkeypatch.setattr(tcore, "sample_probe",
                        lambda cfg, g, b, d: torch.from_numpy(eps[:cfg.nprobes, :b, :cfg.nz]))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))
    monkeypatch.setattr(tcore, "sample_base",
                        lambda cfg, g, n, d: torch.from_numpy(z1[:n, :cfg.nz]))


def _x(b=B, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal((b, 2))).astype(np.float32)


def _jax_run(jicnf, jparams, mode, x, ys):
    jm = JMode(mode.value)
    l = jcnf.loss(jicnf, jm, x, jparams, key=jax.random.PRNGKey(3), ys=ys)
    g = jax.grad(lambda p: jcnf.loss(jicnf, jm, x, p, key=jax.random.PRNGKey(3), ys=ys))(jparams)
    s = jcnf.generate(jicnf, jm, jparams, jax.random.PRNGKey(2), 4,
                      ys=None if ys is None else ys[:4])
    return float(l), _jleaves(g), np.asarray(s)


def _torch_run(ticnf, tparams, mode, x, ys):
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tys = None if ys is None else torch.from_numpy(ys)
    l = tcnf.loss(ticnf, mode, torch.from_numpy(x), p, torch.Generator().manual_seed(3), ys=tys)
    g = dict(zip(p, torch.autograd.grad(l, list(p.values()))))
    s = tcnf.generate(ticnf, mode, tparams, torch.Generator().manual_seed(2), 4,
                      ys=None if tys is None else tys[:4])
    return float(l), _leaves(g), s.detach().numpy()


# ---- JAX's layout parity matrix ----

@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST])
@pytest.mark.parametrize("trace", [TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP])
@pytest.mark.parametrize("conditioned", [False, True])
@pytest.mark.parametrize("planar", [False, True])
def test_feature_first_matches_jax_and_batch_first(same_draws, mode, trace, conditioned, planar):
    """JAX's ``test_feature_first_layout_parity`` matrix: the port's
    feature-first loss, parameter gradients and samples against JAX's
    feature-first ones and against the port's batch-first ones."""
    ncond = 2 if conditioned else 0
    jicnf, jparams, ticnf, tparams = _pair(planar=planar, trace=JTrace(trace.value),
                                           nconditions=ncond)
    x = _x()
    ys = np.ones((B, ncond), np.float32) if conditioned else None
    want = _jax_run(_layout(jicnf, "feature_first"), jparams, mode, x, ys)
    got = {lay: _torch_run(_layout(ticnf, lay), tparams, mode, x, ys) for lay in LAYOUTS}
    for other in (want, got["batch_first"]):
        l, g, s = got["feature_first"]
        assert abs(l - other[0]) < 1e-4
        assert len(g) == len(other[1])
        for a, b in zip(g, other[1]):
            assert np.max(np.abs(a - b)) < 1e-3
        assert np.max(np.abs(s - other[2])) < 1e-4


# ---- the exact trace ----

def _dynamics(jicnf, jparams, ticnf, tparams, mode, t=0.4, ys=None):
    """``du`` at one state from the JAX feature-first twin and the port's
    two layouts (the feature-first results transposed back)."""
    cfg = ticnf.config
    u = (0.5 * np.random.default_rng(1).standard_normal((6, cfg.state_dim))).astype(np.float32)
    jff = _layout(jicnf, "feature_first")
    jys = None if ys is None else jnp.asarray(ys.T)
    want = np.asarray(jax.jit(jdyn(jff.config, jff.net, JMode(mode.value)))(
        t, jnp.asarray(u.T), {"params": jparams, "eps": None, "ys": jys})).T
    out = {}
    for lay in LAYOUTS:
        tc = dataclasses.replace(cfg, layout=lay)
        f = tdyn.make_augmented_dynamics(tc, ticnf.net, mode)
        ff = lay == "feature_first"
        tu = torch.from_numpy(u.T.copy() if ff else u)
        tys = None if ys is None else torch.from_numpy(ys.T.copy() if ff else ys)
        with torch.no_grad():
            du = f(t, tu, {"params": tparams, "eps": None, "ys": tys})
        out[lay] = (du.t() if ff else du).numpy()
    return want, out


@pytest.mark.parametrize("net", ["mlp-analytic", "planar", "deep-sweep", "deep-sweep-chunked",
                                 "reg-j-sweep"])
def test_exact_trace_matches_jax(net):
    """The analytic MLP trace, the planar trace, and the generic exact sweep
    (a 3-hidden-layer MLP, whole and in blocks of 3 basis rows; the analytic
    MLP with ``reg_j``, which takes the sweep for its Frobenius norm)."""
    kw = dict(exact_chunk=3) if net == "deep-sweep-chunked" else {}
    hidden = (12, 12, 12) if "deep" in net else None
    mode = Mode.TEST
    if net == "reg-j-sweep":
        kw.update(trace=JTrace.EXACT, lambda_2=0.5)
        mode = Mode.TRAIN
    jicnf, jparams, ticnf, tparams = _pair(planar=net == "planar", hidden=hidden,
                                           autonomous=False, **kw)
    want, got = _dynamics(jicnf, jparams, ticnf, tparams, mode)
    for lay in LAYOUTS:
        np.testing.assert_allclose(got[lay], want, rtol=1e-5, atol=1e-6)


def test_conditioned_exact_trace_matches_jax():
    jicnf, jparams, ticnf, tparams = _pair(nconditions=2)
    ys = np.random.default_rng(3).standard_normal((6, 2)).astype(np.float32)
    want, got = _dynamics(jicnf, jparams, ticnf, tparams, Mode.TEST, ys=ys)
    for lay in LAYOUTS:
        np.testing.assert_allclose(got[lay], want, rtol=1e-5, atol=1e-6)


# ---- the adaptive solvers and both adjoints ----

ADAPTIVE = {
    "dopri5-backsolve": dict(method="dopri5", rtol=1e-4, atol=1e-4),
    "dopri5-quadrature": dict(method="dopri5", rtol=1e-4, atol=1e-4, gradient="quadrature"),
    "abm-quadrature": dict(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature"),
}


@pytest.mark.parametrize("solver", list(ADAPTIVE))
def test_adaptive_solves_take_equal_steps(same_draws, solver):
    """TRAIN loss and gradients through the adaptive solve and its adjoint:
    the port's feature-first against JAX's feature-first and the port's
    batch-first, with equal NFE and steps."""
    jicnf, jparams, ticnf, tparams = _pair(ADAPTIVE[solver])
    x = _x(16)
    jff = _layout(jicnf, "feature_first")
    _lp, _augs, jst = jcnf.inference(jff, JMode.TRAIN, x, jparams, key=jax.random.PRNGKey(3))
    want = _jax_run(jff, jparams, Mode.TRAIN, x, None)
    counts = {}
    for lay in LAYOUTS:
        tic = _layout(ticnf, lay)
        _l, st = tcnf.loss_with_stats(tic, Mode.TRAIN, torch.from_numpy(x), tparams,
                                      torch.Generator().manual_seed(3))
        counts[lay] = (int(st.nfe), int(st.naccept), int(st.nreject))
        l, g, s = _torch_run(tic, tparams, Mode.TRAIN, x, None)
        assert abs(l - want[0]) < 1e-4
        for a, b in zip(g, want[1]):
            assert np.max(np.abs(a - b)) < 1e-3
        assert np.max(np.abs(s - want[2])) < 1e-4
    jcounts = (int(jst.nfe), int(jst.naccept), int(jst.nreject))
    assert counts["feature_first"] == counts["batch_first"] == jcounts


# ---- trajectory ----

def test_trajectory_forces_batch_first():
    """JAX's ``test_trajectory_feature_first_layout``: ``trajectory`` builds
    batch-first state and forces the batch-first dynamics, so a
    feature-first config's path is the batch-first one's (rtol 1e-5 / atol
    1e-6, as JAX's test) and JAX's feature-first path with its steps (the
    port's trajectory tolerance against JAX, rtol 2e-4 / atol 2e-5, as
    ``tests/test_torch_ode_adaptive.py``)."""
    jicnf, jparams, ticnf, tparams = _pair(dict(method="dopri5", rtol=1e-5, atol=1e-5))
    x = _x(6)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    jpath, jst = jcnf.trajectory(_layout(jicnf, "feature_first"), x, jparams, jnp.asarray(ts))
    out = {lay: tcnf.trajectory(_layout(ticnf, lay), torch.from_numpy(x), tparams,
                                torch.from_numpy(ts)) for lay in LAYOUTS}
    (pff, sff), (pbf, sbf) = out["feature_first"], out["batch_first"]
    np.testing.assert_allclose(pff.numpy(), pbf.numpy(), rtol=1e-5, atol=1e-6)
    counts = lambda st: tuple(int(v) for v in (st.nfe, st.naccept, st.nreject))
    assert counts(sff) == counts(sbf) == counts(jst)
    np.testing.assert_allclose(pff.numpy(), np.asarray(jpath), rtol=2e-4, atol=2e-5)


# ---- fit ----

N, BATCH = 384, 128


def test_three_step_fit_matches_jax(monkeypatch):
    """``ICNFModel.fit`` on the feature-first config, 3 steps, against JAX's
    with the same params, draws and batch order."""
    rng = np.random.default_rng(3)
    eps = rng.standard_normal((1, BATCH, 5)).astype(np.float32)
    t1 = np.float32(1.05)
    order = rng.permutation(N).reshape(N // BATCH, BATCH)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))
    monkeypatch.setattr(jcnf.ICNFModel, "_batches", lambda self, key, n: order)
    monkeypatch.setattr(tcnf.ICNFModel, "_batches", lambda self, g, n: torch.from_numpy(order))
    solver = dict(method="rk4", gradient="backprop", fixed_steps=8)
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver), layout="feature_first")
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.array(jdata.gaussian_mixture(jax.random.PRNGKey(1), N), np.float32)
    jres = jcnf.ICNFModel(jicnf, batchsize=BATCH, epochs=1, log_every=1).fit(x, params=jparams)
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), layout="feature_first")
    tres = tcnf.ICNFModel(ticnf, batchsize=BATCH, epochs=1, log_every=1, device="cpu").fit(
        x, params=params_from_jax(jparams))
    assert tres.stats["iterations"] == jres.stats["iterations"] == 3
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-5)
    for a, b in zip(params_to_jax(tres.params), jax.device_get(jres.params)):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a["b"], b["b"], rtol=1e-4, atol=1e-6)


# ---- no fused route ----

FUSED = {
    "K3": (dict(method="rk4", gradient="backprop", fixed_steps=4), {}),
    "K1": (dict(method="rk4", gradient="backprop", fixed_steps=4), dict(lambda_1=0.0,
                                                                          lambda_2=0.0)),
    "K5": (dict(method="dopri5", rtol=1e-4, atol=1e-4), dict(fused_adaptive=True)),
}


@pytest.mark.parametrize("route", list(FUSED))
def test_fused_takes_the_unfused_route(monkeypatch, route):
    """``fused=True`` with ``feature_first`` solves unfused, as in JAX: the
    gates refuse it, no kernel wrapper is called, and the result is the
    ``fused=False`` one's."""
    solver, kw = FUSED[route]
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), fused=True,
                             layout="feature_first", **kw)
    cfg = ticnf.config
    assert not tdyn.fused_dynamics_applicable(cfg, ticnf.net, Mode.TRAIN)
    assert not fused_solve.fused_solve_applicable(cfg, ticnf.net, Mode.TRAIN)
    assert not fused_adaptive.fused_adaptive_applicable(cfg, ticnf.net, Mode.TRAIN)
    bf = _layout(ticnf, "batch_first")
    assert (tdyn.fused_dynamics_applicable(bf.config, bf.net, Mode.TRAIN)
            or fused_solve.fused_solve_applicable(bf.config, bf.net, Mode.TRAIN)
            or fused_adaptive.fused_adaptive_applicable(bf.config, bf.net, Mode.TRAIN))
    tparams = ticnf.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_x(128))

    def refuse(*a, **k):
        raise AssertionError("a kernel's wrapper was called on a feature-first solve")

    for mod, name in ((tdyn, "fused_dynamics_vjp"), (tcore, "fused_solve_rk4"),
                      (tcore, "fused_solve_dopri5"), (fused_dynamics, "fused_dynamics_vjp")):
        monkeypatch.setattr(mod, name, refuse)
    got = tcnf.loss(ticnf, Mode.TRAIN, x, tparams, torch.Generator().manual_seed(1))
    plain = dataclasses.replace(ticnf, config=dataclasses.replace(cfg, fused=False,
                                                                  fused_adaptive=False))
    want = tcnf.loss(plain, Mode.TRAIN, x, tparams, torch.Generator().manual_seed(1))
    assert torch.equal(got, want)


# ---- export ----

@pytest.mark.parametrize("solver", ["rk4-4", "dopri5"])
def test_exported_feature_first_logpdf_matches_eager(solver):
    """``export_logpdf`` of a feature-first config (the symbolic batch on
    axis 1 of the state inside the loop) against the eager call: equal
    steps, rtol 1e-5; and against JAX's feature-first eager call."""
    s = (dict(method="rk4", gradient="backprop", fixed_steps=4) if solver == "rk4-4"
         else dict(method="dopri5", rtol=1e-4, atol=1e-4))
    jicnf, jparams, ticnf, tparams = _pair(s, layout="feature_first")
    art = ex._export_logpdf(ticnf, tparams, device="cpu")
    for b in (3, 7):
        x = _x(b, seed=b)
        got, nfe, nacc, nrej = art.call(torch.from_numpy(x))
        with torch.no_grad():
            eager, _a, st = tcnf.inference(ticnf, Mode.TEST, torch.from_numpy(x), tparams)
        assert (int(nfe), int(nacc), int(nrej)) == (int(st.nfe), int(st.naccept),
                                                   int(st.nreject))
        torch.testing.assert_close(got, eager, rtol=1e-5, atol=1e-6)
        want = np.asarray(jcnf.inference(jicnf, JMode.TEST, x, jparams)[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_entry_points_run_feature_first():
    """The rest of the public surface on a feature-first config (the default
    stack): ``generate_with_logp``, ``ICNFDist``'s log-density and samples,
    and ``export_sampler`` with the exact trace, each against the port's
    batch-first config (the samples 1e-4 absolute, as JAX's layout test;
    the log-densities rtol 1e-5); the exported sampler against its eager
    ``generate`` at rtol 1e-5."""
    _j, _jp, ticnf, tparams = _pair(dict(method="dopri5", rtol=1e-4, atol=1e-4))
    x = torch.from_numpy(_x(6))
    out = {}
    for lay in LAYOUTS:
        tic = _layout(ticnf, lay)
        d = tcnf.ICNFDist(tic, tparams)
        with torch.no_grad():
            s, lp = tcnf.generate_with_logp(tic, Mode.TEST, tparams,
                                            torch.Generator().manual_seed(4), 5)
            out[lay] = (s, lp, d.logpdf(x), d.sample(5, torch.Generator().manual_seed(4)))
    for a, b in zip(out["feature_first"], out["batch_first"]):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    tic = _layout(ticnf, "feature_first")
    got = ex.export_sampler(tic, tparams, 5, trace_free=False, device="cpu").call(4)
    with torch.no_grad():
        want = tcnf.generate(tic, Mode.TEST, tparams, torch.Generator().manual_seed(4), 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
