"""The rest of the port's serving export against the JAX package's: the abm
solver's device loop, the written-out exact sweep (an MLP of any depth, every
activation with a written-out derivative, a ``CondLayer``, and a
``from_torch`` net through its ``torch.fx`` graph), and the Student-t
sampler (its gamma rounds in a ``while_loop``).

Tolerances: abm's device loop against its eager loop takes the same steps
and gives the same bits; the exported log-densities against JAX's export at
rtol 1e-5 (fp32 solves, sums in another order), with the adaptive solves'
NFE, accepted and rejected steps equal to JAX's and to the port's eager
call, whose bits the served call gives; the written-out sweep against the
forward-mode one (``torch.autograd.forward_ad``) at rtol 1e-6 / atol 1e-6
(the same products, the tangents' sums in another order), and so is a
``from_torch`` net's through its fx graph, whose export matches its eager
call (forward mode) at rtol 1e-5 with the same steps; the loss
gradients through the written-out sweep against ``jax.grad`` within 2e-4 of
each tensor's largest entry, as ``tests/test_torch_dynamics_exact.py``; the
exported Student-t sampler equals the eager ``generate`` bit for bit; the
gamma draws pass a Kolmogorov-Smirnov test against ``scipy.stats.gamma`` at
p > 1e-3 on 20,000 draws."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
import torch.nn.functional as F

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu.config import ICNFConfig as JConfig
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.utils import export as jex
from continuousnormalizingflows_tpu_torch import distributions as tdists
from continuousnormalizingflows_tpu_torch.config import ICNFConfig, Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import dynamics as tdyn
from continuousnormalizingflows_tpu_torch.ops.ode import odeint_abm, odeint_device
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax

ABM = dict(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature")
DOPRI5 = dict(method="dopri5", rtol=1e-4, atol=1e-4)
RK4_2 = dict(method="rk4", gradient="backprop", fixed_steps=2)  # where steps do not matter
# the written-out activations and their JAX twins
ACTS = {"softplus": (F.softplus, jax.nn.softplus), "tanh": (torch.tanh, jnp.tanh),
        "sigmoid": (torch.sigmoid, jax.nn.sigmoid), "relu": (F.relu, jax.nn.relu),
        "elu": (F.elu, jax.nn.elu),
        "gelu": (F.gelu, functools.partial(jax.nn.gelu, approximate=False)),
        "silu": (F.silu, jax.nn.silu)}
COND = np.array([0.5, -1.0], np.float32)


def _counts(st):
    return tuple(int(v) for v in (st.nfe, st.naccept, st.nreject))


def _x(n, seed=0, width=2):
    return (0.3 * np.random.default_rng(seed).standard_normal((n, width))).astype(np.float32)


def _pair(solver, hidden=None, act="softplus", cond=False, scale=1.0, **kw):
    """The same model in both packages (JAX's init times ``scale``,
    converted): the default net, or an MLP of ``hidden`` widths with
    ``act``, inside a ``CondLayer`` of :data:`COND` with ``cond``."""
    jcfg, tcfg = JConfig(nvariables=2, solver=JSolver(**solver), **kw), ICNFConfig(
        nvariables=2, solver=SolverConfig(**solver), **kw)
    if hidden is None:
        jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**solver), **kw)
        ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), **kw)
    else:
        extra = len(COND) if cond else 0
        widths = (tcfg.n_in + extra,) + tuple(hidden) + (tcfg.n_out,)
        jnet, tnet = jcnf.MLP(widths, activation=ACTS[act][1]), tcnf.MLP(
            widths, activation=ACTS[act][0])
        if cond:
            jnet, tnet = jcnf.CondLayer(jnet, jnp.asarray(COND)), tcnf.CondLayer(
                tnet, torch.from_numpy(COND))
        jicnf, ticnf = jcnf.ICNF(config=jcfg, net=jnet), tcnf.ICNF(config=tcfg, net=tnet)
    jparams = jax.tree_util.tree_map(lambda v: scale * v,
                                     jax.device_get(jicnf.init(jax.random.PRNGKey(0))))
    return jicnf, jparams, ticnf, params_from_jax(jparams)


# ---- abm: the device loop ----

@pytest.mark.parametrize("order", [1, 3, 12])
def test_abm_device_loop_takes_the_eager_loops_steps(order):
    """``odeint_device`` against the eager abm loop on a tuple state with a
    stiff-ish field that rejects steps: the same steps, the same bits; an
    exhausted budget poisons both alike."""
    cfg = SolverConfig(method="abm", rtol=1e-4, atol=1e-4, abm_order=order,
                       gradient="quadrature")
    a = torch.tensor([[-30.0, 1.0], [0.0, -2.0]])
    f = lambda t, y, args: (y[0] @ a + torch.sin(t), -y[1] * y[0].sum())
    y0 = (torch.ones(3, 2), torch.ones(1))
    y_e, st_e = odeint_abm(f, y0, 0.0, 1.0, None, cfg)
    with torch.no_grad():
        y_d, st_d = odeint_device(f, y0, 0.0, 1.0, None, cfg)
    assert _counts(st_d) == _counts(st_e) and st_e.nreject > 0
    assert torch.equal(st_d.dt_final, st_e.dt_final)
    for u, v in zip(y_d, y_e):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    short = dataclasses.replace(cfg, max_steps=5)
    with torch.no_grad():
        y_d, st_d = odeint_device(f, y0, 0.0, 1.0, None, short)
    assert _counts(st_d) == _counts(odeint_abm(f, y0, 0.0, 1.0, None, short)[1])
    assert _counts(st_d)[0] == 1 + 2 * 5
    assert all(bool(torch.isnan(v).all()) for v in y_d)


def test_abm_logpdf_export_matches_jax_over_batch_sizes():
    """The reference's default stack (abm, quadrature adjoint) served: one
    program at batches 1, 7 and 32 against JAX's export, the steps equal to
    JAX's and to the eager call's, whose bits it gives."""
    jicnf, jparams, ticnf, tparams = _pair(ABM, scale=2.0)
    art = ex._export_logpdf(ticnf, tparams, device="cpu")
    jart = jex.export_logpdf(jicnf, jparams)
    rejected = 0
    for n in (1, 7, 32):
        x = _x(n, n)
        got, nfe, nacc, nrej = art.call(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jart.call(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
        _lp, _a, want_st = jcnf.inference(jicnf, JMode.TEST, jnp.asarray(x), jparams)
        with torch.no_grad():
            eager, _a, eager_st = tcnf.inference(ticnf, Mode.TEST, torch.tensor(x), tparams)
        assert (int(nfe), int(nacc), int(nrej)) == _counts(eager_st) == _counts(want_st)
        torch.testing.assert_close(got, eager, rtol=0, atol=0)
        rejected += int(nrej)
    assert rejected > 0


def test_abm_sampler_exports():
    _j, _jp, ticnf, tparams = _pair(ABM)
    s = ex.export_sampler(ticnf, tparams, 8, device="cpu").call(3)
    with torch.no_grad():
        want = tcnf.generate(ticnf, Mode.TEST, tparams, torch.Generator().manual_seed(3), 8,
                             trace_free=True)
    torch.testing.assert_close(s, want, rtol=0, atol=0)


# ---- the written-out exact sweep ----

def _sweeps(net, params, cfg, u, t=0.3, chunk=0, ys=None):
    """The exact sweep's ``(dz, div, sum J^2)`` written out and by forward
    mode, at the state ``u``."""
    nz = cfg.nz
    z = u[..., :nz]
    x_full = tdyn._net_input(cfg, t, z, ys)
    field = tdyn.make_field(cfg, net)
    written = lambda tg: tdyn._written_jvps(*tdyn._written_net(net), params, x_full, nz, tg)
    forward = lambda tg: tdyn._jvps(lambda zz: field(t, zz, params, ys), z, tg)
    return (tdyn._exact_sweep(written, z, nz, chunk, True),
            tdyn._exact_sweep(forward, z, nz, chunk, True))


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("act", list(ACTS))
def test_written_sweep_matches_forward_mode(act, depth):
    cfg = ICNFConfig(nvariables=3)
    net = tcnf.MLP((cfg.n_in,) + (16,) * depth + (cfg.n_out,), activation=ACTS[act][0])
    params = net.init(torch.Generator().manual_seed(depth), device="cpu")
    u = torch.randn((8, cfg.state_dim), generator=torch.Generator().manual_seed(1))
    assert tdyn.exact_trace_traceable(net)
    for chunk in (0, 3):
        got, want = _sweeps(net, params, cfg, u, chunk=chunk)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inner", ["mlp", "planar"])
def test_written_sweep_matches_forward_mode_under_cond_layer(inner):
    """Zero tangents on the condition columns (and the time column): the
    sweep of a ``CondLayer`` around an MLP or a planar net, conditioned
    through the config too."""
    cfg = ICNFConfig(nvariables=3, nconditions=1)
    ys = torch.full((8, 1), 0.7)
    n_in = cfg.n_in + len(COND)
    body = (tcnf.MLP((n_in, 16, 16, 16, cfg.n_out), activation=F.silu) if inner == "mlp"
            else tcnf.Planar(n_in, cfg.n_out))
    net = tcnf.CondLayer(body, torch.from_numpy(COND))
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    u = torch.randn((8, cfg.state_dim), generator=torch.Generator().manual_seed(1))
    got, want = _sweeps(net, params, cfg, u, ys=ys)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", list(ACTS))
def test_written_activation_exports_match_jax(act):
    """A 3-hidden-layer MLP with each written-out activation (the sweep)
    exported, against JAX's export and the eager call."""
    jicnf, jparams, ticnf, tparams = _pair(RK4_2, (8, 8, 8), act)
    x = _x(5, 1)
    got = ex.export_logpdf(ticnf, tparams, device="cpu").call(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.export_logpdf(jicnf, jparams).call(x)),
                               rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        torch.testing.assert_close(got, tcnf.log_prob(ticnf, Mode.TEST, torch.tensor(x), tparams),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("net", ["depth-4", "cond-layer", "gelu-2-hidden"])
def test_deep_and_conditioned_exports_match_jax(net):
    """dopri5 on fields that reject steps: a 4-hidden-layer MLP and a
    CondLayer (the written-out sweep) and a 2-hidden-layer gelu MLP (the
    analytic trace with a written-out derivative), against JAX's export with
    the same steps."""
    # the weights' scale and the points' seed: where JAX's jitted and eager
    # solves and the port's take one step sequence (elsewhere a step's
    # decision can sit on a float32 rounding edge)
    kw, scale, seed = {"depth-4": (dict(hidden=(8, 8, 8, 8)), 2.0, 2),
                       "cond-layer": (dict(hidden=(8, 8, 8), cond=True), 2.5, 2),
                       "gelu-2-hidden": (dict(hidden=(8, 8), act="gelu"), 1.5, 3)}[net]
    jicnf, jparams, ticnf, tparams = _pair(DOPRI5, scale=scale, **kw)
    x = _x(7, seed)
    got, nfe, nacc, nrej = ex._export_logpdf(ticnf, tparams, device="cpu").call(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jex.export_logpdf(jicnf, jparams).call(x)),
                               rtol=1e-5, atol=1e-6)
    _lp, _a, want_st = jcnf.inference(jicnf, JMode.TEST, jnp.asarray(x), jparams)
    with torch.no_grad():
        eager, _a, eager_st = tcnf.inference(ticnf, Mode.TEST, torch.tensor(x), tparams)
    assert (int(nfe), int(nacc), int(nrej)) == _counts(eager_st) == _counts(want_st)
    assert int(nrej) > 0
    torch.testing.assert_close(got, eager, rtol=0, atol=0)


@pytest.mark.parametrize("act", ["gelu", "elu"])
def test_gradients_through_the_written_sweep_match_jax(monkeypatch, act):
    """TRAIN with the exact trace and the Frobenius regularizer takes the
    written-out sweep; its loss gradients (rk4 backprop) against
    ``jax.grad`` with the end time injected."""
    solver = dict(method="rk4", gradient="backprop", fixed_steps=4)
    jicnf, jparams, ticnf, tparams = _pair(solver, (8, 8, 8), act, trace="exact")
    x = _x(8, 3)
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(0.95))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(0.95))
    l_j, g_j = jax.value_and_grad(lambda p: jcnf.loss(
        jicnf, JMode.TRAIN, x, p, key=jax.random.PRNGKey(0)))(jparams)
    p = {k: v.requires_grad_() for k, v in tparams.items()}
    l_t = tcnf.loss(ticnf, Mode.TRAIN, x, p, torch.Generator().manual_seed(0))
    g_t = torch.autograd.grad(l_t, list(p.values()))
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=2e-5, atol=2e-4)
    for a, b in zip(g_t, params_from_jax(jax.device_get(g_j)).values()):
        a, b = a.numpy(), b.numpy()
        assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max()


# ---- a from_torch net's forward mode through its torch.fx graph ----

class _Residual(torch.nn.Module):
    """A from_torch net of every op the fx forward mode carries: nn.Linear,
    F.softplus, a tanh module, a residual ``+``, ``*`` by a buffer, ``-`` a
    constant, a negation, slicing, reshape/view, ``torch.stack`` and
    ``torch.cat``."""

    def __init__(self, n_in, h, n_out):
        super().__init__()
        self.a, self.b = torch.nn.Linear(n_in, h), torch.nn.Linear(h, h)
        self.act = torch.nn.Tanh()
        self.c = torch.nn.Linear(2 * h, n_out)
        self.register_buffer("scale", torch.tensor(0.5))

    def forward(self, x):
        h = F.softplus(self.a(x))
        r = h + self.act(self.b(h)) * self.scale - 0.1
        pair = torch.stack([h[..., 3:], 2 * h[..., 3:]], dim=-1).view(h.shape[:-1] + (-1,))
        z = torch.cat([r, -h[..., :3].reshape(h.shape[:-1] + (3,)), pair[..., :h.shape[-1] - 3]],
                      dim=-1)
        return self.c(z)


def _fx_net(kind, cfg):
    if kind == "sequential":
        module = torch.nn.Sequential(torch.nn.Linear(cfg.n_in, 16), torch.nn.Softplus(),
                                     torch.nn.Linear(16, 16), torch.nn.Softplus(),
                                     torch.nn.Linear(16, cfg.n_out))
    else:
        module = _Residual(cfg.n_in, 8, cfg.n_out)
    return tcnf.from_torch(module, cfg.n_in, cfg.n_out)


@pytest.mark.parametrize("ff", [False, True], ids=["batch_first", "feature_first"])
@pytest.mark.parametrize("kind", ["sequential", "residual"])
def test_fx_jvps_match_forward_mode(kind, ff):
    """``(field, J tangents)`` of a from_torch net through its fx graph
    against forward mode (``torch.autograd.forward_ad``): the sweep's basis
    rows (whole and in blocks of 3, with ``sum J^2``) and a probe stack, in
    both layouts; rtol 1e-6 / atol 1e-6, as the written-out sweep of the
    port's nets.  Eager solves keep forward mode."""
    cfg = ICNFConfig(nvariables=3, layout="feature_first" if ff else "batch_first")
    net = _fx_net(kind, cfg)
    assert tdyn.fx_refusal(net) is None and tdyn.exact_trace_traceable(net)
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    u = torch.randn((8, cfg.state_dim), generator=torch.Generator().manual_seed(1))
    nz, t = cfg.nz, 0.3
    z = u[:, :nz].t().contiguous() if ff else u[:, :nz]
    field = (tdyn.make_field_t if ff else tdyn.make_field)(cfg, net)
    x_full = tdyn._net_input(cfg, t, z, None, ff)
    written = lambda tg: tdyn._written_jvps(*tdyn._written_net(net, fx=True), params, x_full, nz,
                                            tg, ff)
    forward = lambda tg: tdyn._jvps(lambda zz: field(t, zz, params, None), z, tg)
    for chunk in (0, 3):
        got = tdyn._exact_sweep(written, z, nz, chunk, True, ff=ff)
        want = tdyn._exact_sweep(forward, z, nz, chunk, True, ff=ff)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    probes = torch.randn((2,) + z.shape, generator=torch.Generator().manual_seed(2))
    for a, b in zip(written(probes), forward(probes)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert tdyn._written_net(net) is None  # eager: forward mode


@pytest.mark.parametrize("solver", ["rk4-4", "dopri5"])
@pytest.mark.parametrize("kind", ["sequential", "residual"])
def test_fx_exact_trace_exports_match_eager(kind, solver):
    """A from_torch net's exact TEST log-density exported with the symbolic
    batch, against the eager call (forward mode): the same steps, rtol 1e-5;
    and its exported sampler with ``trace_free=False`` against the eager
    ``generate``."""
    spec = dict(method="rk4", gradient="backprop", fixed_steps=4) if solver == "rk4-4" else DOPRI5
    cfg = ICNFConfig(nvariables=2, solver=SolverConfig(**spec))
    icnf = tcnf.ICNF(cfg, _fx_net(kind, cfg))
    params = icnf.init(torch.Generator().manual_seed(3), device="cpu")
    art = ex._export_logpdf(icnf, params, device="cpu")
    for b in (3, 6):
        x = torch.from_numpy(_x(b, b))
        got, nfe, nacc, nrej = art.call(x)
        with torch.no_grad():
            eager, _a, st = tcnf.inference(icnf, Mode.TEST, x, params)
        assert (int(nfe), int(nacc), int(nrej)) == _counts(st)
        torch.testing.assert_close(got, eager, rtol=1e-5, atol=1e-6)
    if solver == "rk4-4":
        s = ex.export_sampler(icnf, params, 6, trace_free=False, device="cpu").call(4)
        with torch.no_grad():
            want = tcnf.generate(icnf, Mode.TEST, params, torch.Generator().manual_seed(4), 6)
        torch.testing.assert_close(s, want, rtol=1e-5, atol=1e-6)


def test_convert_carries_deep_and_conditioned_nets():
    """``utils.convert`` both ways for a 4-hidden-layer MLP and a CondLayer
    around one: the same bits back, the same field in both packages."""
    for cond in (False, True):
        jicnf, jparams, ticnf, tparams = _pair(RK4_2, (8, 8, 8, 8), "tanh", cond=cond)
        back = params_to_jax(tparams)
        assert len(back) == 5
        for a, b in zip(back, jparams):
            assert all(np.array_equal(a[k], np.asarray(b[k])) for k in ("w", "b"))
        x = _x(4, 5, ticnf.net.n_in)
        np.testing.assert_allclose(ticnf.net.apply(tparams, torch.tensor(x)).numpy(),
                                   np.asarray(jicnf.net.apply(jparams, x)), rtol=1e-6,
                                   atol=1e-6)


# ---- the Student-t sampler ----

def test_student_t_sampler_exports_with_the_eager_bits(tmp_path):
    _j, _jp, ticnf, tparams = _pair(RK4_2, naugments=0, lambda_3=0.0)
    ticnf = tcnf.ICNF(config=dataclasses.replace(ticnf.config, base_dist=tdists.student_t(4.0)),
                      net=ticnf.net)
    art = ex.export_sampler(ticnf, tparams, 64, device="cpu")
    s = art.call(7)
    assert s.shape == (64, 2) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(art.call(7), s, rtol=0, atol=0)
    with torch.no_grad():
        want = tcnf.generate(ticnf, Mode.TEST, tparams, torch.Generator().manual_seed(7), 64,
                             trace_free=True)
    torch.testing.assert_close(s, want, rtol=0, atol=0)
    path = str(tmp_path / "student.pt2")
    ex.save_artifact(path, art)
    torch.testing.assert_close(ex.load_artifact(path).call(7), s, rtol=0, atol=0)


@pytest.mark.parametrize("alpha", [2.0, 0.75])
def test_gamma_draws_pass_kolmogorov_smirnov(alpha):
    draws = tdists._gamma(torch.Generator().manual_seed(0), (20_000,), alpha).numpy()
    assert scipy.stats.kstest(draws, scipy.stats.gamma(alpha).cdf).pvalue > 1e-3
