"""The image-scale FFJORD path at a small size, against the JAX package.

The model is ``benchmarks/image_bitsdim.py``'s at side 4 (d = 16) and
h = 16: no augmentation, lambda_1 = lambda_2 = 0.01, lambda_3 = 0, no
steering, rk4-24 with backprop, ``fused=True`` (on the CPU the plain
versions of K1 and K2 carry it), data from ``smooth_image_mixture``.  The
eval twin is dopri5 at rtol = atol = 1e-4, exported.  Both packages run
float32 products here (``precision="highest"``: on the CPU the JAX
package's ``"default"`` is float32 too, the port's rounds to bf16 as the
card does), so the loss is held to rtol 1e-5 and each parameter gradient
to 1e-4 of its largest entry (24 steps and their exact backward, sums in
another order), the exported log-density to rtol 1e-5 with equal steps.
The digits-shaped route (K3 + K4, fed by ``random_shift_images``) is held
by its launch pattern and the port's own bf16 fused and unfused routes, to
2e-2 of the loss (bf16 operands in both, other orders).
"""

import functools

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
from continuousnormalizingflows_tpu.utils import datasets as jd
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.models.nets import MLP
from continuousnormalizingflows_tpu_torch.ops import fused_dynamics as fd
from continuousnormalizingflows_tpu_torch.ops import fused_solve as fs
from continuousnormalizingflows_tpu_torch.utils import datasets as td
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

SIDE, H, B, STEPS = 4, 16, 32, 24
D = SIDE * SIDE
IMAGE = dict(nvariables=D, naugments=0, lambda_1=0.01, lambda_2=0.01, lambda_3=0.0,
             steer_rate=0.0)
RK4 = dict(method="rk4", gradient="backprop", fixed_steps=STEPS)
DOPRI5 = dict(method="dopri5", rtol=1e-4, atol=1e-4)


def _models(solver, fused=False, precision="highest"):
    jcfg = jcnf.ICNFConfig(solver=JSolver(**solver), **IMAGE)
    jicnf = jcnf.ICNF(config=jcfg, net=JMLP((jcfg.n_in, H, H, jcfg.n_out), precision=precision))
    tcfg = tcnf.ICNFConfig(solver=SolverConfig(**solver), fused=fused, **IMAGE)
    ticnf = tcnf.ICNF(config=tcfg, net=MLP((tcfg.n_in, H, H, tcfg.n_out), precision=precision))
    return jicnf, ticnf


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)


def test_fused_image_loss_and_grads_match_jax(monkeypatch):
    """K1 + K2's route: at d = 784 the net input (785) is past the whole-solve
    kernel's width limit (128); at side 4 the limit is lowered to 16, so
    n_in = 17 is past it likewise."""
    monkeypatch.setattr(fs, "MAX_WIDTH", D)
    jicnf, ticnf = _models(RK4, fused=True)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.asarray(jd.smooth_image_mixture(jax.random.PRNGKey(1), B, SIDE))
    eps = np.random.default_rng(2).standard_normal((1, B, D)).astype(np.float32)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    counts = {}
    _counting(monkeypatch, fd, "mlp3_forward_vjp_reference", counts)
    _counting(monkeypatch, fd, "fused_dynamics_vjp_bwd_reference", counts)

    jl, jg = jax.value_and_grad(
        lambda p: jcnf.loss(jicnf, JMode.TRAIN, jnp.asarray(x), p, key=jax.random.PRNGKey(3))
    )(jparams)
    tp = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    tl = tcnf.loss(ticnf, Mode.TRAIN, torch.tensor(x), tp, torch.Generator().manual_seed(3))
    tg = torch.autograd.grad(tl, list(tp.values()))
    # the card's launch pattern: 96 stages, each again under remat, 96 backwards
    assert counts == {"mlp3_forward_vjp_reference": 2 * 4 * STEPS,
                      "fused_dynamics_vjp_bwd_reference": 4 * STEPS}
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    want = [g for layer in jg for g in (layer["w"].T, layer["b"])]
    for got, w in zip(tg, want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_image_eval_export_matches_jax():
    jicnf, ticnf = _models(DOPRI5)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.asarray(jd.smooth_image_mixture(jax.random.PRNGKey(4), 24, SIDE))
    art = ex._export_logpdf(ticnf, params_from_jax(jparams), device="cpu")
    lp, nfe, nacc, nrej = art.call(torch.tensor(x))
    want, _a, st = jcnf.inference(jicnf, JMode.TEST, jnp.asarray(x), jparams)
    assert (int(nfe), int(nacc), int(nrej)) == (int(st.nfe), int(st.naccept), int(st.nreject))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), rtol=1e-5)
    bpd = td.nats_to_bits_per_dim(-lp.mean(), D)
    assert float(bpd) == pytest.approx(float(jd.nats_to_bits_per_dim(-jnp.mean(want), D)),
                                       rel=1e-5)


def test_digits_shaped_fit_takes_the_whole_solve_route(monkeypatch):
    """``fused=True`` at bf16 with ``random_shift_images`` as the batch
    transform: each step one whole solve and its backward (the plain
    versions of K3 and K4 here), none of the stage; the first loss against
    the unfused route on the same draws."""
    _j, ticnf = _models(RK4, fused=True, precision="default")
    _j, plain = _models(RK4, fused=False, precision="default")
    x = td.smooth_image_mixture(torch.Generator().manual_seed(5), 4 * B, SIDE)
    counts = {}
    for name in ("_rk4_reference", "_rk4_bwd_reference"):
        _counting(monkeypatch, fs, name, counts)
    _counting(monkeypatch, fd, "mlp3_forward_vjp_reference", counts)
    shift = functools.partial(td.random_shift_images, side=SIDE)
    params = ticnf.init(torch.Generator().manual_seed(0), device="cpu")
    fits = [tcnf.ICNFModel(m, batchsize=B, epochs=1, log_every=1, batch_transform=shift,
                           device="cpu").fit(x, params=params) for m in (ticnf, plain)]
    assert counts == {"_rk4_reference": 4, "_rk4_bwd_reference": 4}
    assert all(np.isfinite(f.history).all() and len(f.history) == 4 for f in fits)
    assert fits[0].history[0] == pytest.approx(fits[1].history[0], rel=2e-2)
