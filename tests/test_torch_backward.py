"""The port's backward against JAX: the plain versions of K2 (stage backward)
and K4 (whole-solve RK4 backward) against the JAX Pallas kernels' custom-VJP
rules (interpret mode on CPU), and ``torch.autograd.grad`` of ``loss``
against ``jax.grad`` of ``loss`` with the same params and injected draws.

Gradients are held per tensor to ``max|port - jax| <= tol * max|jax|``: a
weight gradient sums over rows (and stages), so its small entries are
differences of large terms with an absolute error of the size of the
largest.  fp32: tol 2e-5 for a stage (the JAX kernel tests' bound), 2e-4
for an 8-step solve and for the loss gradients (the kernel-vs-scan bound).
bf16: both sides round the same operands and the products are exact in fp32
(measured: 2.8e-7 of the largest entry at every shape here), but a sum in
another order can move a later bf16 rounding by one place (2^-8 relative),
which tol 1e-2 allows."""

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
from continuousnormalizingflows_tpu.models.nets import MLP as JMLP
from continuousnormalizingflows_tpu.ops.pallas_kernels import fused_dynamics_vjp as jax_stage
from continuousnormalizingflows_tpu.ops.pallas_solve import fused_solve_rk4 as jax_solve
from continuousnormalizingflows_tpu.utils import datasets as jdata
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
    fused_dynamics_vjp,
    fused_dynamics_vjp_bwd_reference,
    mlp3_forward_vjp_reference,
)
from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
    fused_solve_rk4,
    fused_solve_rk4_bwd_reference,
)
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

B = 32
TILE = 8
STEPS = 8
STAGE_TOL = {None: 2e-5, "bf16": 1e-2}
SOLVE_TOL = {None: 2e-4, "bf16": 1e-2}


def _close_to_max(got, want, tol):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= tol * scale, f"tensor {i}: max abs err {err:.3e}, max |want| {scale:.3e}"


def _flat_port(out):
    xbar, epsbar, wbars = out
    return [xbar.numpy(), epsbar.numpy(), *(w.numpy() for w in wbars)]


def _flat_jax(xbar, epsbar, pbar):
    """JAX cotangents in the port's layout (weights transposed to nn.Linear)."""
    port = params_from_jax(jax.device_get(pbar))
    return [np.asarray(xbar), np.asarray(epsbar), *(v.numpy() for v in port.values())]


# (n_in, h, nz): the flagship stage, a ragged width, the tabular width, the
# FFJORD form's net on a 13-row batch (a ragged last tile on both sides), and
# an image-shaped net (n_in = nz + 1, nz close to h, as 785 -> 1024 -> 784)
STAGE_SHAPES = {"flagship": (6, 24, 5), "ragged": (5, 20, 4), "tabular": (44, 176, 43),
                "ffjord": (3, 12, 2), "image": (65, 96, 64)}
STAGE_BATCH = {"ffjord": 13}


def _stage_setup(shape):
    n_in, h, nz = STAGE_SHAPES[shape]
    B = STAGE_BATCH.get(shape, 32)
    jparams = jax.device_get(JMLP((n_in, h, h, nz)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, n_in)).astype(np.float32)
    eps = rng.standard_normal((B, nz)).astype(np.float32)
    cot = (rng.standard_normal((B, nz)).astype(np.float32),
           rng.standard_normal((B, nz)).astype(np.float32),
           *rng.standard_normal((3, B)).astype(np.float32))
    return jparams, x, eps, cot, nz


@pytest.mark.parametrize("shape, prec", [("flagship", None), ("ragged", None),
                                         ("tabular", None), ("flagship", "bf16"),
                                         ("tabular", "bf16"), ("ffjord", None),
                                         ("image", None), ("image", "bf16")])
def test_stage_backward_matches_jax_kernel(shape, prec):
    jparams, x, eps, cot, nz = _stage_setup(shape)
    jcdt = None if prec is None else jnp.bfloat16
    tcdt = None if prec is None else torch.bfloat16
    want = jax.jit(lambda x_, e_, p_, c_: jax.vjp(
        lambda a, b, c: jax_stage(a, b, c, nz, TILE, jcdt), x_, e_, p_)[1](c_))(
        x, eps, jparams, cot)
    got = fused_dynamics_vjp_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(eps), params_from_jax(jparams), nz,
        tuple(torch.from_numpy(c) for c in cot), tcdt)
    _close_to_max(_flat_port(got), _flat_jax(*want), STAGE_TOL[prec])


def test_stage_backward_matches_autograd_of_plain_forward():
    jparams, x, eps, cot, nz = _stage_setup("flagship")
    params = params_from_jax(jparams)
    names = list(params)
    tcot = tuple(torch.from_numpy(c) for c in cot)

    def fwd(xx, ee, *ws):
        return mlp3_forward_vjp_reference(xx, ee, dict(zip(names, ws)), nz)

    _out, vjp_fn = torch.func.vjp(fwd, torch.from_numpy(x), torch.from_numpy(eps),
                                  *params.values())
    want = [t.numpy() for t in vjp_fn(tcot)]
    got = fused_dynamics_vjp_bwd_reference(torch.from_numpy(x), torch.from_numpy(eps), params,
                                           nz, tcot)
    _close_to_max(_flat_port(got), want, STAGE_TOL[None])


def test_stage_function_backward_is_the_plain_backward():
    """Autograd through fused_dynamics_vjp on CPU tensors runs the plain K2."""
    jparams, x, eps, cot, nz = _stage_setup("ragged")
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(eps).requires_grad_()
    tcot = tuple(torch.from_numpy(c) for c in cot)
    out = fused_dynamics_vjp(xt, et, params, nz)
    got = torch.autograd.grad(out, [xt, et, *params.values()], tcot)
    want = fused_dynamics_vjp_bwd_reference(torch.from_numpy(x), torch.from_numpy(eps),
                                            params_from_jax(jparams), nz, tcot)
    for a, b in zip(got, _flat_port(want)):
        np.testing.assert_array_equal(a.numpy(), b)


SOLVE_CASES = {
    "forward": dict(kw={}, span=(0.0, 1.0)),
    "reversed": dict(kw={}, span=(1.0, 0.0)),
    "conditioned": dict(kw=dict(nconditions=2), span=(0.0, 1.0)),
    "bf16": dict(kw={}, span=(0.0, 1.0)),
    # the edges of K4's row-per-thread path on the card, whose plain twin this
    # is: hidden widths 8 and 32 (h <= 32), and a batch of 13 rows, which the
    # JAX kernel takes padded to whole tiles with a zero cotangent
    "h8_conditioned": dict(kw=dict(nconditions=2), span=(0.0, 1.0), h=8),
    "h8_autonomous": dict(kw=dict(autonomous=True), span=(0.0, 1.0), h=8),
    "h32_conditioned": dict(kw=dict(nconditions=2), span=(0.0, 1.0), h=32),
    "h32_autonomous": dict(kw=dict(autonomous=True), span=(0.0, 1.0), h=32),
    "ragged_conditioned": dict(kw=dict(nconditions=2), span=(0.0, 1.0), b=13),
    "ragged_autonomous": dict(kw=dict(autonomous=True), span=(1.0, 0.0), b=13),
    # K4's wide path (h >= 64): its least hidden width, nvariables = 8 (nz =
    # 17), 4 steps, fp32 and bf16
    "h64_conditioned": dict(kw=dict(nconditions=2, nvariables=8), span=(0.0, 1.0), h=64,
                            steps=4),
    "h64_autonomous": dict(kw=dict(autonomous=True, nvariables=8), span=(1.0, 0.0), h=64,
                           steps=4),
    "h64_conditioned_bf16": dict(kw=dict(nconditions=2, nvariables=8), span=(0.0, 1.0), h=64,
                                 steps=4, bf16=True),
    "h64_autonomous_bf16": dict(kw=dict(autonomous=True, nvariables=8), span=(1.0, 0.0), h=64,
                                steps=4, bf16=True),
}


def _solve_setup(case, b=16):
    kw = dict(SOLVE_CASES[case]["kw"])
    nvariables = kw.pop("nvariables", 2)
    b = SOLVE_CASES[case].get("b", b)
    steps = SOLVE_CASES[case].get("steps", STEPS)
    jicnf = jcnf.ICNF.create(
        nvariables=nvariables, solver=JSolver(method="rk4", gradient="backprop",
                                              fixed_steps=steps, remat=False), **kw)
    cfg = jicnf.config
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    if "h" in SOLVE_CASES[case]:
        h = SOLVE_CASES[case]["h"]
        jparams = jax.device_get(JMLP((cfg.n_in, h, h, cfg.nz)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    u0 = (0.5 * rng.standard_normal((b, cfg.state_dim))).astype(np.float32)
    eps = rng.standard_normal((b, cfg.nz)).astype(np.float32)
    ys = rng.standard_normal((b, 2)).astype(np.float32) if cfg.conditioned else None
    gbar = rng.standard_normal((b, cfg.state_dim)).astype(np.float32)
    return cfg, jparams, u0, eps, ys, gbar


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_solve_backward_matches_jax_kernel(case):
    cfg, jparams, u0, eps, ys, gbar = _solve_setup(case)
    span = SOLVE_CASES[case]["span"]
    bf16 = case == "bf16" or SOLVE_CASES[case].get("bf16", False)
    steps = cfg.solver.fixed_steps
    nz = cfg.nz
    t_col = None if cfg.autonomous else nz
    # the JAX kernel takes whole tiles; rows with a zero cotangent add nothing
    b = u0.shape[0]
    jrows = [None if a is None else np.pad(a, ((0, -b % TILE), (0, 0)))
             for a in (u0, eps, ys, gbar)]

    def f(u, e, p):
        return jax_solve(u, e, jrows[2], p, span, nz, t_col, steps, TILE,
                         jnp.bfloat16 if bf16 else None)

    ubar, ebar, pbar = jax.jit(lambda u, e, p, g: jax.vjp(f, u, e, p)[1](g))(
        jrows[0], jrows[1], jparams, jrows[3])
    got = fused_solve_rk4_bwd_reference(
        torch.from_numpy(u0), torch.from_numpy(eps),
        None if ys is None else torch.from_numpy(ys), params_from_jax(jparams), span, nz, t_col,
        steps, torch.from_numpy(gbar), torch.bfloat16 if bf16 else None)
    _close_to_max(_flat_port(got), _flat_jax(ubar[:b], ebar[:b], pbar),
                  SOLVE_TOL["bf16" if bf16 else None])


def test_solve_function_gives_zero_condition_cotangent():
    """As in the JAX rule, K4 carries no cotangent to the conditions ys (and
    none to the time span); u0, eps and the weights get the plain K4's."""
    cfg, jparams, u0, eps, ys, gbar = _solve_setup("conditioned")
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    ut, et, yt = (torch.from_numpy(a).requires_grad_() for a in (u0, eps, ys))
    u1 = fused_solve_rk4(ut, et, yt, params, (0.0, 1.0), cfg.nz, cfg.nz, STEPS)
    got = torch.autograd.grad(u1, [ut, et, yt, *params.values()], torch.from_numpy(gbar))
    assert torch.equal(got[2], torch.zeros_like(yt))
    want = fused_solve_rk4_bwd_reference(
        torch.from_numpy(u0), torch.from_numpy(eps), torch.from_numpy(ys),
        params_from_jax(jparams), (0.0, 1.0), cfg.nz, cfg.nz, STEPS, torch.from_numpy(gbar))
    _close_to_max([g.numpy() for g in got[:2] + got[3:]], _flat_port(want), 1e-6)


# ---- loss gradients, port vs JAX ----

def _models(fused, remat=True):
    jicnf = jcnf.ICNF.create(
        nvariables=2, solver=JSolver(method="rk4", gradient="backprop", fixed_steps=STEPS))
    ticnf = tcnf.ICNF.create(
        nvariables=2, solver=SolverConfig(method="rk4", gradient="backprop",
                                          fixed_steps=STEPS, remat=remat), fused=fused)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    return jicnf, jparams, ticnf


@pytest.fixture
def same_draws(monkeypatch):
    """Both packages' probe and steer samplers return the same arrays."""
    rng = np.random.default_rng(6)
    eps = rng.standard_normal((1, B, 5)).astype(np.float32)
    t1 = np.float32(0.95)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))


def _port_grads(ticnf, mode, x, jparams):
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    loss = tcnf.loss(ticnf, mode, x, params, torch.Generator().manual_seed(0))
    return [g.numpy() for g in torch.autograd.grad(loss, list(params.values()))]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("mode", list(Mode))
def test_loss_gradients_match_jax(same_draws, mode, fused):
    jicnf, jparams, ticnf = _models(fused)
    x = np.array(jdata.gaussian_mixture(jax.random.PRNGKey(1), B), np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jcnf.loss(jicnf, JMode(mode.value), x, p,
                                                 key=jax.random.PRNGKey(0))))(jparams)
    want = [v.numpy() for v in params_from_jax(jax.device_get(jgrad)).values()]
    _close_to_max(_port_grads(ticnf, mode, x, jparams), want, SOLVE_TOL[None])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_remat_gives_the_same_gradients(same_draws, fused):
    """remat recomputes each step in the backward: memory, not values."""
    _j, jparams, ticnf = _models(fused, remat=True)
    _j, _jp, ticnf_keep = _models(fused, remat=False)
    x = np.array(jdata.gaussian_mixture(jax.random.PRNGKey(1), B), np.float32)
    for a, b in zip(_port_grads(ticnf, Mode.TRAIN_NOREG, x, jparams),
                    _port_grads(ticnf_keep, Mode.TRAIN_NOREG, x, jparams)):
        np.testing.assert_array_equal(a, b)
