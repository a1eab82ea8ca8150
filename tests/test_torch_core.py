"""The slice as a whole, port vs JAX: the flagship RNODE (2-D, nz = 5,
MLP 6 -> 24 -> 24 -> 5, rk4 with backprop) at 8 steps on a small batch.

The two packages draw different random numbers, so the probe ``eps`` and the
steered ``t1`` are injected: directly into ``_solve``, or by replacing both
packages' samplers with ones that return the same numpy arrays.  Mode.TEST is
deterministic and goes through the public API as it is.

Tolerance rtol 2e-4 / atol 2e-5 (fp32 solve of 8 RK4 steps, sums in another
order), as the JAX kernel-vs-scan test; ``loss`` is a batch mean of
log-densities of size ~10, held at rtol 2e-5 / atol 2e-4."""

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
from continuousnormalizingflows_tpu.utils import datasets as jdata
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.utils import datasets as tdata
from continuousnormalizingflows_tpu_torch.utils import profiling
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

STEPS = 8
B = 32
RTOL, ATOL = 2e-4, 2e-5


def _models(fused=False, **kw):
    jicnf = jcnf.ICNF.create(
        nvariables=2, solver=JSolver(method="rk4", gradient="backprop", fixed_steps=STEPS),
        **kw)
    ticnf = tcnf.ICNF.create(
        nvariables=2, solver=SolverConfig(method="rk4", gradient="backprop",
                                          fixed_steps=STEPS), fused=fused, **kw)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    return jicnf, jparams, ticnf, params_from_jax(jparams)


def _data(b=B, seed=1):
    return np.array(jdata.gaussian_mixture(jax.random.PRNGKey(seed), b), np.float32)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_test_mode_inference_matches_jax():
    jicnf, jparams, ticnf, tparams = _models()
    x = _data()
    lp_j, augs_j, _ = jcnf.inference(jicnf, JMode.TEST, x, jparams)
    lp_t, augs_t, stats = tcnf.inference(ticnf, Mode.TEST, x, tparams)
    _close(lp_t, lp_j)
    for a, b in zip(augs_t, augs_j):
        _close(a, b)
    assert int(stats) == 4 * STEPS


def test_test_mode_dist_logpdf_matches_jax():
    jicnf, jparams, ticnf, tparams = _models()
    x = _data()
    _close(tcnf.ICNFDist(ticnf, tparams).logpdf(x), jcnf.ICNFDist(jicnf, jparams).logpdf(x))
    # one (d,) sample gives a scalar
    single = tcnf.ICNFDist(ticnf, tparams).logpdf(x[0])
    assert single.ndim == 0
    _close(single, jcnf.ICNFDist(jicnf, jparams).logpdf(x[0]))


def test_conditioned_test_mode_matches_jax():
    jicnf, jparams, ticnf, tparams = _models(nconditions=3)
    x = _data()
    ys = np.random.default_rng(2).standard_normal((1, 3)).astype(np.float32)
    _close(tcnf.CondICNFDist(ticnf, tparams, ys).logpdf(x),
           jcnf.CondICNFDist(jicnf, jparams, ys).logpdf(x))


def _injected(cfg, b, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, b, cfg.nz)).astype(np.float32), np.float32(1.07)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TRAIN_NOREG])
def test_solve_and_split_match_jax(mode, fused):
    jicnf, jparams, ticnf, tparams = _models(fused=fused)
    cfg = ticnf.config
    x = _data()
    eps, t1 = _injected(cfg, B)
    u0 = np.concatenate([x, np.zeros((B, cfg.n_aug_input + 3), np.float32)], axis=-1)
    jmode = JMode(mode.value)
    u1_j, _ = jcore._solve(jicnf, jmode, jnp.asarray(u0), 0.0, jnp.float32(t1), jparams,
                           jnp.asarray(eps), None)
    lp_j, augs_j = jcore._split_terminal(jicnf.config, jmode, u1_j)
    launches = lambda: tuple(profiling.counters().get(f"{k}.launches", 0) for k in ("K3", "K1"))
    counters = launches()
    u1_t, stats = tcore._solve(ticnf, mode, torch.from_numpy(u0), 0.0, torch.tensor(t1),
                               tparams, torch.from_numpy(eps), None)
    assert counters == launches()  # CPU
    lp_t, augs_t = tcore._split_terminal(cfg, mode, u1_t)
    _close(u1_t, u1_j)
    _close(lp_t, lp_j)
    for a, b in zip(augs_t, augs_j):
        _close(a, b)
    assert (stats.nfe, stats.naccept, stats.nreject) == (4 * STEPS, STEPS, 0)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_reversed_span_generate_matches_jax(fused):
    """The generate path's solve, t1 -> t0 from base draws (K3 reversed)."""
    jicnf, jparams, ticnf, tparams = _models(fused=fused)
    cfg = ticnf.config
    rng = np.random.default_rng(4)
    z1 = rng.standard_normal((B, cfg.nz)).astype(np.float32)
    eps, t1 = _injected(cfg, B, seed=5)
    u0 = np.concatenate([z1, np.zeros((B, 3), np.float32)], axis=-1)
    u_j, _ = jcore._solve(jicnf, JMode.TRAIN, jnp.asarray(u0), jnp.float32(t1), 0.0,
                          jparams, jnp.asarray(eps), None)
    u_t, _ = tcore._solve(ticnf, Mode.TRAIN, torch.from_numpy(u0), torch.tensor(t1), 0.0,
                          tparams, torch.from_numpy(eps), None)
    _close(u_t, u_j)


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages' probe, steer and base samplers return the same arrays."""
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((1, B, 5)).astype(np.float32)
    z1 = rng.standard_normal((B, 5)).astype(np.float32)
    t1 = np.float32(0.95)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(jcore, "sample_base", lambda cfg, key, n: jnp.asarray(z1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))
    monkeypatch.setattr(tcore, "sample_base", lambda cfg, g, n, d: torch.from_numpy(z1))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", list(Mode))
def test_loss_matches_jax(same_draws, mode, fused):
    jicnf, jparams, ticnf, tparams = _models(fused=fused)
    x = _data()
    l_j = jcnf.loss(jicnf, JMode(mode.value), x, jparams, key=jax.random.PRNGKey(0))
    l_t = tcnf.loss(ticnf, mode, x, tparams, torch.Generator().manual_seed(0))
    _close(l_t, l_j, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", [Mode.TEST, Mode.TRAIN])
def test_generate_with_logp_matches_jax(same_draws, mode, fused):
    jicnf, jparams, ticnf, tparams = _models(fused=fused)
    s_j, lp_j = jcnf.generate_with_logp(jicnf, JMode(mode.value), jparams,
                                        jax.random.PRNGKey(0), B)
    s_t, lp_t = tcnf.ICNFDist(ticnf, tparams, mode).sample_with_logpdf(B)
    _close(s_t, s_j)
    _close(lp_t, lp_j)


def test_trace_free_sample_matches_full_path():
    _j, _jp, ticnf, tparams = _models(fused=True)
    d = tcnf.ICNFDist(ticnf, tparams, Mode.TRAIN)
    full = d.sample(B, torch.Generator().manual_seed(9))
    free = d.sample(B, torch.Generator().manual_seed(9), trace_free=True)
    assert full.shape == free.shape == (B, 2)
    _close(free, full)


def test_hutchinson_mean_matches_exact_trace():
    """The probe does not move the flow, so over many probes the TRAIN_NOREG
    log-density's mean is the TEST (exact trace) one: held to 5 standard
    errors of the mean."""
    _j, _jp, ticnf, tparams = _models(fused=True)
    x = torch.from_numpy(_data(b=4))
    reps = 2000
    exact = tcnf.inference(ticnf, Mode.TEST, x, tparams)[0]
    est = tcnf.inference(ticnf, Mode.TRAIN_NOREG, x.repeat(reps, 1), tparams,
                         torch.Generator().manual_seed(11))[0].reshape(reps, 4)
    sem = est.std(dim=0) / reps**0.5
    assert torch.all((est.mean(dim=0) - exact).abs() < 5 * sem + 1e-4)
    assert torch.all(sem > 0)


def test_gaussian_mixture_logpdf_matches_jax():
    x = _data(b=64)
    _close(tdata.gaussian_mixture_logpdf(torch.from_numpy(x)),
           jdata.gaussian_mixture_logpdf(x), rtol=1e-5, atol=1e-5)
    s = tdata.gaussian_mixture(torch.Generator().manual_seed(0), 4096)
    assert s.shape == (4096, 2)
    assert abs(float(s.norm(dim=-1).mean()) - 2.0) < 0.05  # ring of radius 2


@pytest.mark.parametrize(
    "kw, msg",
    [
        (dict(solver=SolverConfig(method="abm")), "adaptive"),
        (dict(solver=SolverConfig(method="abm", gradient="quadrature")), "adaptive"),
    ],
)
def test_unported_solvers_raise(kw, msg):
    """No solver is left to port: the adaptive multistep solver, the last
    one, now runs under both adjoints (held against JAX in
    test_torch_abm_model.py)."""
    icnf = tcnf.ICNF.create(nvariables=2, **kw)
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    lp, _augs, stats = tcnf.inference(icnf, Mode.TEST, torch.zeros(4, 2), params)
    assert torch.isfinite(lp).all() and lp.shape == (4,), msg
    assert stats.nfe == 1 + 2 * (stats.naccept + stats.nreject), msg


@pytest.mark.parametrize("entry", ["ICNF.init", "MLP.init"])
def test_init_runs_on_the_card_unless_asked_for_the_cpu(entry, monkeypatch):
    """``init`` puts the params on the card by default; without CUDA it
    raises an error that names ``device="cpu"``, and ``device="cpu"`` gives
    the same params on the CPU.  ``ICNFDist`` and ``inference`` follow the
    params' device."""
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(method="rk4", gradient="backprop",
                                                              fixed_steps=STEPS))
    init = icnf.init if entry == "ICNF.init" else icnf.net.init
    asked = []
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.Tensor, "to", lambda t, device, *a, **k: asked.append(device) or t)
        init(torch.Generator().manual_seed(0))
    assert asked and all(torch.device(d) == torch.device("cuda") for d in asked)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init(torch.Generator().manual_seed(0))
    params = init(torch.Generator().manual_seed(0), device="cpu")
    assert all(v.device.type == "cpu" for v in params.values())
    lp = tcnf.ICNFDist(icnf, params, Mode.TEST).logpdf(torch.zeros(4, 2))
    assert lp.device.type == "cpu" and lp.shape == (4,)


def test_stochastic_mode_needs_generator():
    _j, _jp, ticnf, tparams = _models()
    with pytest.raises(ValueError, match="Generator"):
        tcnf.inference(ticnf, Mode.TRAIN, torch.zeros(4, 2), tparams)


@pytest.mark.parametrize("method", ["sample", "sample_with_logpdf", "rand"])
@pytest.mark.parametrize("conditioned", [False, True], ids=["plain", "conditioned"])
def test_sample_argument_order_is_named(method, conditioned):
    """The port takes ``(n, generator=None)``, the reverse of the JAX
    package's ``(key, n)``: a call in JAX's order, or a generator that is not
    one, raises a TypeError that names the port's order; the right order gives
    what a direct call of the core gives for the same generator."""
    if conditioned:
        _j, _jp, ticnf, tparams = _models(nconditions=3)
        d = tcnf.CondICNFDist(ticnf, tparams, np.ones((1, 3), np.float32), Mode.TRAIN)
    else:
        _j, _jp, ticnf, tparams = _models()
        d = tcnf.ICNFDist(ticnf, tparams, Mode.TRAIN)
    call = getattr(d, method)
    name = "sample" if method == "rand" else method
    for args, kw in (((torch.Generator().manual_seed(0), 4), {}), ((4,), dict(generator=4))):
        with pytest.raises(TypeError, match=rf"{name}\(n, generator=None\)"):
            call(*args, **kw)
    got = call(4, torch.Generator().manual_seed(9))
    core_fn = tcore.generate_with_logp if method == "sample_with_logpdf" else tcore.generate
    want = core_fn(ticnf, Mode.TRAIN, tparams, torch.Generator().manual_seed(9), 4,
                   ys=d._ys_for(4))
    if method == "sample_with_logpdf":
        assert got[0].shape == (4, 2) and got[1].shape == (4,)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert got.shape == (4, 2) and torch.equal(got, want)
