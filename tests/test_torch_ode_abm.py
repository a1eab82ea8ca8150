"""The port's variable-step, variable-order Adams-Bashforth-Moulton solver
against the JAX package's.

Step statistics (NFE, accepted, rejected) must be equal: the port runs the
same controller on the same Milne estimates.  Values: rtol 1e-5 in float32
and 1e-10 in float64, with an absolute floor for the elements near zero
(the states are O(1): 1e-6 in float32, 1e-10 in float64).  Two matrices over ``abm_order`` in {1, 2, 4, 8, 12},
forward and reverse: float32 on the flagship's augmented dynamics (2-D
RNODE, B = 16) at rtol = atol = 1e-6, where the smooth random-init field
keeps the order at or below 4; float64 on a random tanh field at 1e-7,
where the order climbs to 8-9.  Where orders above 4 run in float32 (the
tanh field at 1e-4) the step counts still agree, but the high orders'
weights amplify rounding: the two packages end up to 4e-5 apart, and each
is as far from a float64 solve of the same steps, so there the values are
held at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.ops import ode as jode
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import ode as tode
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics as tdyn
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

ORDERS = [1, 2, 4, 8, 12]
SPANS = [(0.0, 1.0), (1.0, 0.0)]
SPAN_IDS = ["forward", "reverse"]


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


@pytest.mark.parametrize("span", SPANS, ids=SPAN_IDS)
@pytest.mark.parametrize("order", ORDERS)
def test_float32_matches_jax_on_the_flagship_field(order, span):
    jicnf = jcnf.ICNF.create(nvariables=2)
    ticnf = tcnf.ICNF.create(nvariables=2)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    u0 = np.concatenate([rng.standard_normal((16, 2)), np.zeros((16, 6))],
                        axis=-1).astype(np.float32)
    eps = rng.standard_normal((1, 16, 5)).astype(np.float32)
    jargs = {"params": jparams, "eps": jnp.asarray(eps), "ys": None}
    targs = {"params": params_from_jax(jparams), "eps": torch.from_numpy(eps), "ys": None}
    jf = jdyn(jicnf.config, jicnf.net, JMode.TRAIN)
    tf = tdyn(ticnf.config, ticnf.net, Mode.TRAIN)
    solver = dict(method="abm", rtol=1e-6, atol=1e-6, abm_order=order)
    (y_j, s_j), (y_t, s_t) = _solve_both(jf, tf, u0, span, solver, jargs, targs)
    assert s_t == s_j and s_t[0] == 1 + 2 * (s_t[1] + s_t[2])
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("span", SPANS, ids=SPAN_IDS)
@pytest.mark.parametrize("order", ORDERS)
def test_float64_matches_jax(x64, order, span):
    jf, tf, y0 = _tanh_field(np.float64)
    solver = dict(method="abm", rtol=1e-7, atol=1e-7, abm_order=order)
    (y_j, s_j), (y_t, s_t) = _solve_both(jf, tf, y0, span, solver)
    assert s_t == s_j
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("span", [(0.0, 2.0), (2.0, 0.0)], ids=SPAN_IDS)
def test_high_orders_in_float32_take_jax_steps(span):
    jf, tf, y0 = _tanh_field(np.float32)
    orders = []
    factor = tode._controller_factor

    def spy(ratio, inv, *a):  # the order kept on an accept is 1 / inv[2] - 1
        orders.append(round(1.0 / float(inv[2])) - 1)
        return factor(ratio, inv, *a)

    solver = dict(method="abm", rtol=1e-4, atol=1e-4, abm_order=12)
    try:
        tode._controller_factor = spy
        (y_j, s_j), (y_t, s_t) = _solve_both(jf, tf, y0, span, solver)
    finally:
        tode._controller_factor = factor
    assert max(orders) >= 6
    assert s_t == s_j
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-4)
