"""Port K3 (whole-solve RK4) vs JAX: the port's plain version against the JAX
Pallas kernel (interpret mode on CPU) and against the JAX solve of the same
dynamics (``odeint_diff`` over ``make_augmented_dynamics``, Mode.TRAIN).

Tolerance rtol 2e-4 / atol 2e-5, as the JAX kernel-vs-scan test: 8 steps x 4
stages of fp32 arithmetic summed in another order on each side.  The bf16
comparison holds the port's rounding to the JAX kernel's bf16 compute dtype
(same operands rounded, products exact; the fp32 sums differ in order and can
move a later bf16 rounding by one place), rtol 2e-3 / atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.models.nets import MLP as JMLP
from continuousnormalizingflows_tpu.ops.adjoint import odeint_diff as j_odeint_diff
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as j_make
from continuousnormalizingflows_tpu.ops.pallas_solve import fused_solve_rk4 as j_fused_solve
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.models.nets import MLP
from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
    fused_solve_applicable,
    fused_solve_rk4,
    fused_solve_rk4_reference,
)
from continuousnormalizingflows_tpu_torch.utils import profiling
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

STEPS = 8
B = 16

CASES = {
    "plain": dict(),
    "conditioned": dict(nconditions=2),
    "autonomous": dict(autonomous=True),
    # the widths of K3's wide path on the card, whose plain twin this is:
    # its least hidden width, nvariables = 8 (nz = 17), 4 steps
    "h64_conditioned": dict(nconditions=2, nvariables=8),
    "h64_autonomous": dict(autonomous=True, nvariables=8),
}
WIDE = {"h64_conditioned": (64, 4), "h64_autonomous": (64, 4)}  # (hidden width, steps)


def _setup(case, b=B):
    kw = dict(CASES[case])
    nvariables = kw.pop("nvariables", 2)
    h, steps = WIDE.get(case, (None, STEPS))
    solver = JSolver(method="rk4", gradient="backprop", fixed_steps=steps, remat=False)
    jicnf = jcnf.ICNF.create(nvariables=nvariables, solver=solver, **kw)
    if h:
        cfg = jicnf.config
        jicnf = jcnf.ICNF.create(nvariables=nvariables, solver=solver,
                                 net=JMLP((cfg.n_in, h, h, cfg.nz)), **kw)
    cfg = jicnf.config
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    u0 = (0.5 * rng.standard_normal((b, cfg.state_dim))).astype(np.float32)
    eps = rng.standard_normal((1, b, cfg.nz)).astype(np.float32)
    ys = np.full((b, 2), 0.3, np.float32) if cfg.conditioned else None
    return jicnf, jparams, u0, eps, ys


def _port(cfg, jparams, u0, eps, ys, tspan, cdt=None):
    return fused_solve_rk4_reference(
        torch.from_numpy(u0), torch.from_numpy(eps[0]),
        None if ys is None else torch.from_numpy(ys), params_from_jax(jparams), tspan,
        cfg.nz, None if cfg.autonomous else cfg.nz, cfg.solver.fixed_steps, cdt,
    ).numpy()


def _jax_kernel(cfg, jparams, u0, eps, ys, tspan, cdt=None):
    t_col = None if cfg.autonomous else cfg.nz
    steps = cfg.solver.fixed_steps
    return np.asarray(jax.jit(
        lambda u, e, p: j_fused_solve(u, e[0], ys, p, tspan, cfg.nz, t_col, steps, 8, cdt)
    )(u0, eps, jparams))


def _jax_solve(jicnf, jparams, u0, eps, ys, tspan):
    f_aug = j_make(jicnf.config, jicnf.net, JMode.TRAIN)
    args = {"params": jparams, "eps": eps, "ys": ys}
    return np.asarray(jax.jit(
        lambda u, a: j_odeint_diff(f_aug, u, tspan[0], tspan[1], a, jicnf.config.solver)[0]
    )(u0, args))


SPANS = {"forward": (0.0, 1.0), "reversed": (1.0, 0.0)}


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel(case, span):
    jicnf, jparams, u0, eps, ys = _setup(case)
    got = _port(jicnf.config, jparams, u0, eps, ys, SPANS[span])
    want = _jax_kernel(jicnf.config, jparams, u0, eps, ys, SPANS[span])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_solve(case, span):
    jicnf, jparams, u0, eps, ys = _setup(case)
    got = _port(jicnf.config, jparams, u0, eps, ys, SPANS[span])
    want = _jax_solve(jicnf, jparams, u0, eps, ys, SPANS[span])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_plain_bf16_matches_jax_bf16_kernel():
    jicnf, jparams, u0, eps, ys = _setup("plain")
    got = _port(jicnf.config, jparams, u0, eps, ys, (0.0, 1.0), torch.bfloat16)
    want = _jax_kernel(jicnf.config, jparams, u0, eps, ys, (0.0, 1.0), jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("case", WIDE)
def test_plain_bf16_matches_jax_bf16_kernel_wide(case):
    """The bf16 comparison above at the widths of K3's wide path."""
    jicnf, jparams, u0, eps, ys = _setup(case)
    got = _port(jicnf.config, jparams, u0, eps, ys, (0.0, 1.0), torch.bfloat16)
    want = _jax_kernel(jicnf.config, jparams, u0, eps, ys, (0.0, 1.0), jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_device_scalar_times_and_ragged_batch():
    """A steered end time arrives as a tensor; a batch of 13 needs no tiling."""
    jicnf, jparams, u0, eps, ys = _setup("plain", b=13)
    cfg = jicnf.config
    before = profiling.counters().get("K3.launches", 0)
    got = fused_solve_rk4(torch.from_numpy(u0), torch.from_numpy(eps[0]), None,
                          params_from_jax(jparams), (0.0, torch.tensor(1.05)), cfg.nz,
                          cfg.nz, STEPS).numpy()
    assert profiling.counters().get("K3.launches", 0) == before
    want = _jax_solve(jicnf, jparams, u0, eps, ys, (0.0, 1.05))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _gate_icnf(**kw):
    solver = kw.pop("solver", SolverConfig(method="rk4", gradient="backprop", fixed_steps=8))
    return tcnf.ICNF.create(nvariables=2, solver=solver, fused=True, **kw)


def test_gate_takes_the_flagship_train_solve():
    icnf = _gate_icnf()
    assert fused_solve_applicable(icnf.config, icnf.net, Mode.TRAIN)


@pytest.mark.parametrize(
    "kw, mode",
    [
        (dict(), Mode.TRAIN_NOREG),
        (dict(), Mode.TEST),
        (dict(fused=False), Mode.TRAIN),
        (dict(nprobes=2), Mode.TRAIN),
        (dict(lambda_1=0.0), Mode.TRAIN),
        (dict(lambda_2=0.0), Mode.TRAIN),
        (dict(solver=SolverConfig(method="euler", gradient="backprop")), Mode.TRAIN),
        (dict(net=MLP((6, 513, 513, 5))), Mode.TRAIN),
        (dict(net=MLP((6, 24, 5))), Mode.TRAIN),
        (dict(net=MLP((6, 24, 24, 5), activation=torch.tanh)), Mode.TRAIN),
    ],
    ids=lambda v: str(v) if not isinstance(v, dict) else ",".join(map(str, v)),
)
def test_gate_rejects(kw, mode):
    if "fused" in kw:
        icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(
            method="rk4", gradient="backprop", fixed_steps=8), fused=False)
    else:
        icnf = _gate_icnf(**kw)
    assert not fused_solve_applicable(icnf.config, icnf.net, mode)
