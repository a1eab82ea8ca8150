"""The port's training front-end against the JAX package's: the optimizer
against optax, ``ICNFModel.fit`` against the JAX ``fit`` with the same
initial params, draws and batch order, and the facade's own contracts
(steps_per_dispatch parity, exact resume, validation and early stopping,
checkpoints, the conditional model).

Tolerances: the optimizer rtol 1e-6 / atol 1e-7 (the same fp32 Adam
arithmetic in another order); ``fit`` after 3 steps, params rtol 1e-4 /
atol 1e-6 and losses rtol 1e-5 (measured: 6.0e-8 max abs on the params,
6.6e-7 relative on the losses; Adam's normalised step can pass a gradient's
last-digit difference on to a whole update of 1e-3 only where a gradient
entry is near zero, which these inputs do not hit)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.utils import datasets as jdata
from continuousnormalizingflows_tpu_torch.config import SolverConfig
from continuousnormalizingflows_tpu_torch.utils.checkpoint import load_checkpoint
from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax

STEPS = 8


def _solver(steps=STEPS):
    return SolverConfig(method="rk4", gradient="backprop", fixed_steps=steps)


# ---- optimizer ----

@pytest.mark.parametrize("clip_norm", [None, 0.5], ids=["noclip", "clip"])
def test_default_optimizer_matches_optax(clip_norm):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (4,), (2, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # gradient norms from ~0.1 to ~3: clip_norm 0.5 takes both branches
    grads = [[(0.05 * 10 ** (k / 2) * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for k in range(5)]
    tx = jcnf.default_optimizer(clip_norm=clip_norm)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.tensor(a, requires_grad=True) for a in p0]
    opt = tcnf.default_optimizer(clip_norm=clip_norm)(tp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, a in zip(tp, g):
            t.grad = torch.tensor(a)
        opt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_default_optimizer_is_coupled_l2_adam():
    """Weight decay enters the gradient before Adam's moments (not AdamW)."""
    opt = tcnf.default_optimizer(learning_rate=0.1, weight_decay=0.5)([torch.ones(1)])
    assert isinstance(opt, torch.optim.Adam) and not isinstance(opt, torch.optim.AdamW)
    assert opt.defaults["weight_decay"] == 0.5 and opt.defaults["lr"] == 0.1


# ---- fit vs the JAX fit ----

N, BATCH = 384, 128


@pytest.fixture
def same_draws_and_batches(monkeypatch):
    """Both packages draw the same probe and end time at every step and take
    the same batch order (the JAX step is traced once, so its draws are
    constants; the port's samplers return the same constants)."""
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


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_fit_matches_jax_fit(same_draws_and_batches, fused):
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(method="rk4", gradient="backprop",
                                                          fixed_steps=STEPS))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.array(jdata.gaussian_mixture(jax.random.PRNGKey(1), N), np.float32)
    jres = jcnf.ICNFModel(jicnf, batchsize=BATCH, epochs=1, log_every=1).fit(x, params=jparams)
    ticnf = tcnf.ICNF.create(nvariables=2, solver=_solver(), fused=fused)
    tres = tcnf.ICNFModel(ticnf, batchsize=BATCH, epochs=1, log_every=1, device="cpu").fit(
        x, params=params_from_jax(jparams))
    assert tres.stats["iterations"] == jres.stats["iterations"] == 3
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-5)
    for a, b in zip(params_to_jax(tres.params), jax.device_get(jres.params)):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a["b"], b["b"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("spd", [1, 2], ids=["per_step", "blocks_of_2"])
def test_carry_fit_matches_jax_fit(same_draws_and_batches, spd):
    """The reference-default adaptive stack (dopri5, 1e-4, backsolve adjoint)
    with ``dt0="carry"``: each step's forward and backward solves start from
    the previous step's final step size (the first from the fixed start).
    Held step for step over 3 steps, as the fixed-step fit above; adaptive
    adjoint fits are chaotically marginal over long runs (ROADMAP, Queue 3),
    so no longer history is compared."""
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(dt0="carry"))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = np.array(jdata.gaussian_mixture(jax.random.PRNGKey(1), N), np.float32)
    jres = jcnf.ICNFModel(jicnf, batchsize=BATCH, epochs=1, log_every=1,
                          steps_per_dispatch=spd).fit(x, params=jparams)
    ticnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(dt0="carry"))
    tres = tcnf.ICNFModel(ticnf, batchsize=BATCH, epochs=1, log_every=1,
                          steps_per_dispatch=spd, device="cpu").fit(
        x, params=params_from_jax(jparams))
    assert tres.stats["iterations"] == jres.stats["iterations"] == 3
    for key in ("nfe", "naccept", "nreject"):
        assert tres.stats[key] == jres.stats[key]
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-5)
    for a, b in zip(params_to_jax(tres.params), jax.device_get(jres.params)):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(a["b"], b["b"], rtol=1e-4, atol=1e-6)


# ---- the facade's own contracts (port only, small) ----

def _small(nconditions=0, fused=False):
    return tcnf.ICNF.create(nvariables=2, nconditions=nconditions, solver=_solver(4),
                            fused=fused)


def _x(n=96, seed=5):
    return gaussian_mixture(torch.Generator().manual_seed(seed), n)


def _equal(p, q):
    return all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_steps_per_dispatch_bit_parity(fused):
    x = _x()
    runs = [tcnf.ICNFModel(_small(fused=fused), batchsize=16, epochs=2, log_every=1,
                           steps_per_dispatch=k, device="cpu").fit(x) for k in (1, 4)]
    assert runs[0].stats["iterations"] == runs[1].stats["iterations"] == 12
    assert _equal(runs[0].params, runs[1].params)
    assert runs[0].history == runs[1].history


def test_resume_is_exact():
    x = _x()
    model = tcnf.ICNFModel(_small(), batchsize=32, epochs=2, device="cpu")
    whole = model.fit(x)
    model.epochs = 1
    first = model.fit(x)
    second = model.fit(x, params=first.params, opt_state=first.opt_state,
                       generator=first.generator)
    assert _equal(whole.params, second.params)


def test_fit_leaves_given_params_untouched_and_logs():
    x = _x()
    params = _small().init(torch.Generator().manual_seed(1), device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    seen = []
    res = tcnf.ICNFModel(_small(), batchsize=32, epochs=2, log_every=2,
                         callback=lambda it, l: seen.append(it), device="cpu").fit(x, params=params)
    assert _equal(params, before)
    assert seen == [0, 2, 4] and len(res.history) == 3
    assert all(np.isfinite(res.history))
    s = res.stats
    assert (s["iterations"], s["epochs_run"], s["nfe"], s["naccept"]) == (6, 2, 16, 4)
    assert not any(v.requires_grad for v in res.params.values())


def test_validation_tracks_best_and_keeps_the_stream():
    x, xval = _x(), _x(48, seed=6)
    plain = tcnf.ICNFModel(_small(), batchsize=32, epochs=3, device="cpu").fit(x)
    evals = []
    val = tcnf.ICNFModel(_small(), batchsize=32, epochs=3,
                         val_callback=lambda e, v: evals.append(e), device="cpu").fit(
        x, validation_data=xval, eval_every=2)
    assert evals == [2, 3] and [e for e, _ in val.val_history] == [2, 3]
    assert _equal(plain.params, val.params)  # validation draws nothing
    best = min(val.val_history, key=lambda ev: ev[1])
    assert (val.best_epoch, val.best_val_nll) == best
    assert _equal(val.best_params, val.params) == (val.best_epoch == 3)
    assert val.stats["val_evals"] == 2 and not val.stats["stopped_early"]


def test_early_stopping_on_patience():
    """A diverged fit (learning rate 1.0: the parameters are NaN after the
    first epoch) stops after ``patience`` non-finite evaluations, with no
    best parameters."""
    x, xval = _x(), _x(48, seed=6)
    model = tcnf.ICNFModel(_small(), optimizer=tcnf.default_optimizer(learning_rate=1.0),
                           batchsize=32, epochs=6, device="cpu")
    res = model.fit(x, validation_data=xval, patience=2)
    assert res.stats["stopped_early"]
    assert res.stats["epochs_run"] == len(res.val_history) == 2
    assert all(np.isnan(v) for _, v in res.val_history)
    assert res.best_epoch is None and res.best_params is None and res.best_val_nll is None
    with pytest.raises(ValueError, match="eval_every"):
        model.fit(x, validation_data=xval, eval_every=0)


def test_save_load_round_trip(tmp_path):
    x = _x()
    model = tcnf.ICNFModel(_small(), batchsize=32, epochs=1, device="cpu")
    res = model.fit(x)
    model.save(str(tmp_path / "ckpt"), res)
    params = model.load(str(tmp_path / "ckpt"))
    assert _equal(params, res.params)
    p2, opt_state, step = load_checkpoint(str(tmp_path / "ckpt"))
    assert step == 3 and _equal(p2, res.params)
    # the saved optimizer state resumes exactly like the in-memory one
    a = model.fit(x, params=res.params, opt_state=res.opt_state,
                  generator=torch.Generator().manual_seed(9))
    b = model.fit(x, params=p2, opt_state=opt_state, generator=torch.Generator().manual_seed(9))
    assert _equal(a.params, b.params)
    np.testing.assert_allclose(model.transform(x[:5], params).numpy(),
                               model.transform(x[:5], res.params).numpy())
    assert model.transform(x[0], params).ndim == 0
    assert np.isfinite(model.score(x, params))


def test_conditional_model():
    x = _x()
    y = torch.randn((96, 1), generator=torch.Generator().manual_seed(2))
    icnf = _small(nconditions=1)
    model = tcnf.CondICNFModel(icnf, batchsize=32, epochs=1, device="cpu")
    res = model.fit(x, y)
    assert res.stats["iterations"] == 3 and np.isfinite(res.stats["final_loss"])
    assert model.transform(x[:4], res.params, Y=y[:4]).shape == (4,)
    with pytest.raises(ValueError, match="requires Y"):
        model.fit(x)
    with pytest.raises(ValueError, match="nconditions"):
        tcnf.CondICNFModel(_small(), device="cpu")


def test_rejects_bad_input_and_unported_options():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcnf.ICNFModel(_small(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match=r"X must be \(n, 2\)"):
        tcnf.ICNFModel(_small(), epochs=1, device="cpu").fit(torch.zeros(8, 3))


@pytest.mark.parametrize("conditional", [False, True], ids=["ICNFModel", "CondICNFModel"])
def test_fit_runs_on_the_card_unless_asked_for_the_cpu(conditional, monkeypatch):
    """The model's device is the card by default; without CUDA ``fit`` raises
    an error that names ``device="cpu"`` (it never carries on on the CPU),
    and ``device="cpu"`` trains there."""
    icnf = _small(nconditions=1) if conditional else _small()
    model_cls = tcnf.CondICNFModel if conditional else tcnf.ICNFModel
    data = (_x(), torch.zeros((96, 1))) if conditional else (_x(),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert model_cls(icnf).device == torch.device("cuda")
    assert model_cls(icnf, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        model_cls(icnf, batchsize=32, epochs=1).fit(*data)
    res = model_cls(icnf, batchsize=32, epochs=1, device="cpu").fit(*data)
    assert res.stats["iterations"] == 3
    assert all(v.device.type == "cpu" for v in res.params.values())


def test_batch_transform_and_eval_icnf():
    x = _x()
    seen = []

    def identity(generator, xb):  # draws nothing: the stream stays the same
        seen.append(tuple(xb.shape))
        return xb

    plain = tcnf.ICNFModel(_small(), batchsize=32, epochs=1, device="cpu").fit(x)
    hooked = tcnf.ICNFModel(_small(), batchsize=32, epochs=1, batch_transform=identity,
                            device="cpu").fit(x)
    assert seen == [(32, 2)] * 3 and _equal(plain.params, hooked.params)
    noisy = tcnf.ICNFModel(_small(), batchsize=32, epochs=1, batch_transform=lambda g, xb: xb
                           + 0.01 * torch.randn(xb.shape, generator=g), device="cpu").fit(x)
    assert not _equal(plain.params, noisy.params)
    fine = tcnf.ICNF.create(nvariables=2, solver=_solver(16))
    model = tcnf.ICNFModel(_small(), eval_icnf=fine, device="cpu")
    assert model.score(x, plain.params) == -float(
        tcnf.ICNFDist(fine, plain.params).logpdf(x).mean())
    with pytest.raises(ValueError, match="eval_icnf"):
        tcnf.ICNFModel(_small(), eval_icnf=tcnf.ICNF.create(nvariables=3, solver=_solver()),
                       device="cpu")
