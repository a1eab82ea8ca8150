"""Checks of the port's Adams-Bashforth-Moulton solver beside the step
matrices of test_torch_ode_abm.py: its weights against the JAX package's,
the dense output, the NaN poison, the popped ``dt0``, the gradients of both
continuous adjoints over it, the float64 order checks (each against JAX),
and the JAX package's own accuracy checks on the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.ops import adjoint as jadjoint
from continuousnormalizingflows_tpu.ops import ode as jode
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import adjoint as tadjoint
from continuousnormalizingflows_tpu_torch.ops import ode as tode
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics as tdyn
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

SPANS = [(0.0, 1.0), (1.0, 0.0)]
SPAN_IDS = ["forward", "reverse"]
GRAD_TOL = 2e-4  # of the largest entry


@pytest.fixture()
def x64():
    with jax.enable_x64(True):
        yield


def _stats(s):
    return int(s.nfe), int(s.naccept), int(s.nreject)


def _tanh_field(dtype, seed=0):
    w = (0.6 * np.random.default_rng(seed).standard_normal((6, 6))).astype(dtype)
    jf = lambda t, y, a: jnp.tanh(y @ jnp.asarray(w).T) - 0.3 * y + 0.2 * jnp.cos(2 * t)
    tf = lambda t, y, a: (torch.tanh(y @ torch.from_numpy(w).T) - 0.3 * y
                          + 0.2 * torch.cos(2 * t))
    return jf, tf, np.linspace(-1.0, 1.0, 12).reshape(2, 6).astype(dtype)


def _solve_both(jf, tf, y0, span, solver, jargs=None, targs=None):
    y_j, s_j = jax.jit(lambda y: jode.odeint(jf, y, *span, jargs, JSolver(**solver)))(
        jnp.asarray(y0))
    y_t, s_t = tode.odeint(tf, torch.from_numpy(y0), *span, targs, SolverConfig(**solver))
    return (np.asarray(y_j), _stats(s_j)), (y_t.numpy(), _stats(s_t))


def test_constants_and_weights_match_jax(x64):
    """The Milne factors, the GL7 Lagrange weights, each order's weights and
    the three candidates' weights at the same node times, in float64."""
    assert tode._MILNE == jode._MILNE and len(tode._MILNE) == tode.ABM_MAX_ORDER
    K = 12
    rng = np.random.default_rng(0)
    ts = 1.0 - np.cumsum(rng.uniform(0.02, 0.05, K))
    t_new = ts[0] + 0.04
    ts_j, ts_t = jnp.asarray(ts), torch.from_numpy(ts)
    tn_j, tn_t = jnp.asarray(t_new), torch.tensor(t_new, dtype=torch.float64)
    for k in (1, 2, 3, 5, 8, 11, 12):
        w_j = jax.jit(lambda t, b: jnp.stack(jode._lagrange_quad_weights(
            [t[i] for i in range(k)], t[0], b)))(ts_j, tn_j)
        w_t = tode._lagrange_quad_weights(ts_t[:k], ts_t[0], tn_t)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-9, atol=1e-13)
        for a, b in zip(tode._abm_weights_order(k, K, ts_t, tn_t),
                        jax.jit(functools.partial(jode._abm_weights_order, k, K))(ts_j, tn_j)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-13)
        branch_t = tode._abm_weights_branch3(k, K, ts_t, tn_t)
        *branch_j, valid = jax.jit(functools.partial(jode._abm_weights_branch3, k, K))(
            ts_j, tn_j)
        rows = [i for i in range(3) if valid[i] > 0]
        for a, b in zip(branch_t, branch_j):
            assert bool(torch.isfinite(a).all())  # a stand-in candidate is finite too
            np.testing.assert_allclose(a.numpy()[rows], np.asarray(b)[rows], rtol=1e-9,
                                       atol=1e-13)
    ws = rng.standard_normal((3, K))
    hist = rng.standard_normal((K, 4, 5))
    np.testing.assert_allclose(tode._hist_dot(torch.from_numpy(ws), torch.from_numpy(hist)),
                               np.asarray(jax.vmap(lambda w: jode._hist_dot(w, hist))(ws)),
                               rtol=1e-12, atol=1e-12)


def _decay(t, y, args):
    return -y


@pytest.mark.parametrize("span", SPANS, ids=SPAN_IDS)
def test_dense_output_matches_jax(span):
    """The interpolant over the accepted nodes (the PECE corrected states and
    their second-evaluate derivatives) on the flagship's TEST dynamics: the
    same steps and nodes as JAX, and the same values at off-node times; the
    plain solve takes the same steps to the same end state."""
    jicnf = jcnf.ICNF.create(nvariables=2)
    ticnf = tcnf.ICNF.create(nvariables=2)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    u0 = np.concatenate([np.random.default_rng(2).standard_normal((16, 2)),
                         np.zeros((16, 6))], axis=-1).astype(np.float32)
    jf = jdyn(jicnf.config, jicnf.net, JMode.TEST)
    tf = tdyn(ticnf.config, ticnf.net, Mode.TEST)
    jargs = {"params": jparams, "eps": None, "ys": None}
    targs = {"params": params_from_jax(jparams), "eps": None, "ys": None}
    cfg = dict(method="abm", rtol=1e-5, atol=1e-5, abm_order=6)
    y_j, s_j, d_j = jax.jit(lambda y: jode.odeint_dense(jf, y, *span, jargs,
                                                        JSolver(**cfg)))(jnp.asarray(u0))
    y_t, s_t, d_t = tode.odeint_dense(tf, torch.from_numpy(u0), *span, targs,
                                      SolverConfig(**cfg))
    assert _stats(s_t) == _stats(s_j) and d_t.n == int(d_j.n) == _stats(s_t)[1] + 1
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    y_p, s_p = tode.odeint(tf, torch.from_numpy(u0), *span, targs, SolverConfig(**cfg))
    assert _stats(s_p) == _stats(s_t) and torch.equal(y_p, y_t)
    for t in (0.0, 0.13, 0.5, 0.77, 1.0, 1.4):
        np.testing.assert_allclose(tode.eval_dense(d_t, t).numpy(),
                                   np.asarray(jode.eval_dense(d_j, jnp.float32(t))),
                                   rtol=1e-5, atol=1e-6)


def test_interpolant_accuracy():
    """The dense output of exp decay within 1e-4 of the solution at 23 times
    (the JAX package's check, on the port), with one node an accepted step."""
    cfg = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, abm_order=6)
    y0 = torch.tensor([1.0, 2.0])
    _y1, stats, dense = tode.odeint_dense(_decay, y0, 0.0, 1.0, None, cfg)
    assert dense.n == stats.naccept + 1
    for t in np.linspace(0.0, 1.0, 23):
        err = (tode.eval_dense(dense, float(t)) - y0 * np.exp(-t)).abs().max()
        assert float(err) < 1e-4, t


def test_budget_exhaustion_and_node_overflow_poison():
    """A solve that runs out of steps, and a dense solve with more accepted
    nodes than ``dense_max_nodes``, return NaN (result and nodes), as in
    JAX."""
    y, _s = tode.odeint(_decay, torch.ones(2), 0.0, 1.0, None,
                        SolverConfig(method="abm", max_steps=3))
    assert torch.isnan(y).all()
    osc = lambda t, y, a: torch.stack([y[1], -y[0]])
    big = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dense_max_nodes=1024)
    y1, _s, dense = tode.odeint_dense(osc, torch.tensor([1.0, 0.0]), 0.0, 20.0, None, big)
    assert torch.isfinite(y1).all() and dense.n > 8
    small = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dense_max_nodes=8)
    y1, _s, dense = tode.odeint_dense(osc, torch.tensor([1.0, 0.0]), 0.0, 20.0, None, small)
    assert torch.isnan(y1).all() and dense.n == 8
    assert torch.isnan(tode.eval_dense(dense, 0.5)).all()


def test_dt0_in_args_is_popped_and_ignored():
    """``args["dt0"]`` (the carry channel) is popped by both forms in both
    packages and changes nothing: ``f`` fails on any key but ``"a"``."""

    def jf(t, y, args):
        assert set(args) == {"a"}, set(args)
        return -args["a"] * y

    def tf(t, y, args):
        assert set(args) == {"a"}, set(args)
        return -args["a"] * y

    cfg = dict(method="abm", rtol=1e-5, atol=1e-5)
    y0 = np.array([1.0, 2.0], np.float32)
    for carry in (None, 0.3):
        extra = {} if carry is None else {"dt0": carry}
        y_j, s_j = jax.jit(lambda y: jode.odeint(jf, y, 0.0, 1.0, {"a": 0.7, **extra},
                                                 JSolver(**cfg)))(jnp.asarray(y0))
        y_jd, s_jd, _d = jax.jit(lambda y: jode.odeint_dense(
            jf, y, 0.0, 1.0, {"a": 0.7, **extra}, JSolver(**cfg)))(jnp.asarray(y0))
        y_t, s_t = tode.odeint(tf, torch.from_numpy(y0), 0.0, 1.0,
                               {"a": 0.7, **{k: torch.tensor(v) for k, v in extra.items()}},
                               SolverConfig(**cfg))
        y_td, s_td, _d = tode.odeint_dense(
            tf, torch.from_numpy(y0), 0.0, 1.0,
            {"a": 0.7, **{k: torch.tensor(v) for k, v in extra.items()}}, SolverConfig(**cfg))
        assert _stats(s_t) == _stats(s_j) == _stats(s_td) == _stats(s_jd)
        if carry is None:
            plain = (y_t, _stats(s_t))
        else:
            assert torch.equal(y_t, plain[0]) and _stats(s_t) == plain[1]
        np.testing.assert_allclose(y_td.numpy(), np.asarray(y_jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gradient", ["adjoint", "quadrature"])
def test_gradients_of_odeint_diff_match_jax(gradient):
    """``odeint_diff`` over abm, backsolve and quadrature adjoint: the
    gradients w.r.t. the parameters and ``y0`` equal JAX's."""
    w = np.array([[0.3, -0.2], [0.1, 0.25]], np.float32)
    y0 = np.array([[1.0, -0.5], [0.2, 0.8], [-1.1, 0.4]], np.float32)
    cfg = dict(method="abm", gradient=gradient, rtol=1e-6, atol=1e-6, abm_order=6)

    def jloss(w_, y_):
        y1, _ = jadjoint.odeint_diff(lambda t, y, a: jnp.tanh(y @ a["w"]), y_, 0.0, 1.0,
                                     {"w": w_}, JSolver(**cfg))
        return jnp.sum(y1 ** 2)

    gw_j, gy_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(y0))
    wt = torch.from_numpy(w).requires_grad_()
    yt = torch.from_numpy(y0).requires_grad_()
    y1, _ = tadjoint.odeint_diff(lambda t, y, a: torch.tanh(y @ a["w"]), yt, 0.0, 1.0,
                                 {"w": wt}, SolverConfig(**cfg))
    gw_t, gy_t = torch.autograd.grad(torch.sum(y1 ** 2), [wt, yt])
    for a, b in ((gw_t, gw_j), (gy_t, gy_j)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * np.abs(b).max()


def test_float64_order_checks_match_jax(x64):
    """At rtol = atol = 1e-10 the high orders win (JAX's float64 test): abm8
    below dopri5 and below 0.6x abm4 in NFE, abm12 below abm8, each within
    1e-8 of a 1e-13 dopri5 solve; the port's NFE equal JAX's."""

    def jf(t, y, args):
        return jnp.tanh(y[::-1]) - 0.5 * y + jnp.sin(3 * t)

    def tf(t, y, args):
        return torch.tanh(torch.flip(y, (0,))) - 0.5 * y + torch.sin(3 * t)

    y0 = np.linspace(-1.0, 1.0, 8)
    ref, _ = tode.odeint(tf, torch.from_numpy(y0), 0.0, 1.0, None,
                         SolverConfig(method="dopri5", rtol=1e-13, atol=1e-13))
    nfes = {}
    for name, kw in [("dopri5", dict(method="dopri5")),
                     ("abm4", dict(method="abm", abm_order=4)),
                     ("abm8", dict(method="abm", abm_order=8)),
                     ("abm12", dict(method="abm", abm_order=12))]:
        solver = dict(rtol=1e-10, atol=1e-10, **kw)
        (y_j, s_j), (y_t, s_t) = _solve_both(jf, tf, y0, (0.0, 1.0), solver)
        assert s_t == s_j, name
        assert float(np.abs(y_t - ref.numpy()).max()) < 1e-8, name
        nfes[name] = s_t[0]
    assert nfes["abm8"] < nfes["dopri5"], nfes
    assert nfes["abm8"] < 0.6 * nfes["abm4"], nfes
    assert nfes["abm12"] < nfes["abm8"], nfes


def test_accuracy_properties():
    """The JAX package's own abm checks, on the port: exp decay within 5e-4
    at the default tolerance with ``nfe = 1 + 2 * steps``; the error falls
    10x from tol 1e-3 to 1e-5 on an oscillator; a forward then reverse solve
    returns to ``y0``; ``dt0="auto"`` is the fixed start; every order cap
    agrees with a tight dopri5 on a random smooth field."""
    y1, s = tode.odeint(_decay, torch.ones(4, 3), 0.0, 1.0, None, SolverConfig(method="abm"))
    assert float((y1 - np.exp(-1.0)).abs().max()) < 5e-4
    assert s.nfe == 1 + 2 * (s.naccept + s.nreject)
    osc = lambda t, y, a: torch.stack([y[1], -y[0]])
    y0 = torch.tensor([1.0, 0.5])
    exact = torch.tensor([np.cos(3.0) + 0.5 * np.sin(3.0), -np.sin(3.0) + 0.5 * np.cos(3.0)],
                         dtype=torch.float32)
    errs = [float((tode.odeint(osc, y0, 0.0, 3.0, None, SolverConfig(
        method="abm", rtol=tol, atol=tol))[0] - exact).abs().max()) for tol in (1e-3, 1e-5)]
    assert errs[1] < errs[0] / 10 and errs[1] < 2e-4, errs
    cfg = SolverConfig(method="abm", rtol=1e-6, atol=1e-6)
    y0 = torch.tensor([[1.0, 2.0]])
    y1, _ = tode.odeint(_decay, y0, 0.0, 1.0, None, cfg)
    assert float((tode.odeint(_decay, y1, 1.0, 0.0, None, cfg)[0] - y0).abs().max()) < 1e-4
    ya, sa = tode.odeint(_decay, torch.tensor([0.5]), 0.0, 1.0, None,
                         SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dt0="auto"))
    yf, sf = tode.odeint(_decay, torch.tensor([0.5]), 0.0, 1.0, None,
                         SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dt0=0.01))
    assert _stats(sa) == _stats(sf) and torch.equal(ya, yf)
    for order in (2, 3, 5, 6, 8):
        w = 0.6 * torch.randn((6, 6), generator=torch.Generator().manual_seed(order))
        f = lambda t, y, a: torch.tanh(y @ w.T) - 0.3 * y + 0.2 * torch.cos(2 * t)
        y0 = torch.linspace(-1.0, 1.0, 6)[None, :]
        for t0, t1 in ((0.0, 2.0), (2.0, 0.0)):
            ref, _ = tode.odeint(f, y0, t0, t1, None,
                                 SolverConfig(method="dopri5", rtol=1e-9, atol=1e-9))
            y1, s = tode.odeint(f, y0, t0, t1, None, SolverConfig(
                method="abm", rtol=1e-5, atol=1e-5, abm_order=order))
            assert float((y1 - ref).abs().max()) < 1e-3, (order, t0)
            assert s.nfe == 1 + 2 * (s.naccept + s.nreject)
