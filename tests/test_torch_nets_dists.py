"""The port's nets (``Planar``, ``planar_h``, ``CondLayer``, ``from_torch``)
and distributions against the JAX package's.

Nets run on params crossed by ``utils.convert`` (``from_torch`` against
``from_flax`` on crossed weights, and against an ``MLP`` with the same
weights).  Each distribution's ``logpdf`` equals JAX's at the same points
(rtol 1e-6).  The samplers draw from another RNG than JAX's, so they are
held statistically at 20,000 draws with fixed seeds: mean and variance
within 4 standard errors of the distribution's, and a Kolmogorov-Smirnov
p-value above 1e-3 against its CDF."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu import distributions as jdists
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu_torch import core as tcore
from continuousnormalizingflows_tpu_torch import distributions as tdists
from continuousnormalizingflows_tpu_torch.config import Mode
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax

N_DRAWS = 20_000


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n_in, n_out, use_bias", [(3, 3, True), (6, 5, True), (4, 4, False)],
                         ids=["square", "6to5", "nobias"])
def test_planar_matches_jax(n_in, n_out, use_bias):
    jnet = jcnf.Planar(n_in, n_out, use_bias=use_bias)
    tnet = tcnf.Planar(n_in, n_out, use_bias=use_bias)
    jparams = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams)
    assert set(tparams) == set(jparams) == ({"u", "w", "b"} if use_bias else {"u", "w"})
    x = _x((7, 2, n_in))  # two leading axes
    np.testing.assert_allclose(tnet.apply(tparams, torch.from_numpy(x)).numpy(),
                               np.asarray(jnet.apply(jparams, x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcnf.planar_h(tnet, tparams, torch.from_numpy(x)).numpy(),
                               np.asarray(jcnf.planar_h(jnet, jparams, x)), rtol=1e-6,
                               atol=1e-6)
    back = params_to_jax(tparams)
    assert all(np.array_equal(back[k], np.asarray(jparams[k])) for k in jparams)
    # the port's own init: glorot-uniform u and w, zero b, one seed one draw
    p = tnet.init(torch.Generator().manual_seed(3), device="cpu")
    assert p["u"].shape == (n_out,) and p["w"].shape == (n_in,)
    assert float(p["u"].abs().max()) <= np.sqrt(6.0 / (1 + n_out))
    assert float(p["w"].abs().max()) <= np.sqrt(6.0 / (n_in + 1))
    assert not use_bias or float(p["b"]) == 0.0
    again = tnet.init(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_cond_layer_matches_jax():
    """The wrapped net sees ``[x, ys]``; a scalar ``ys`` is one column (the
    JAX package's check, held against it)."""
    ys = np.array([0.5, -1.0], np.float32)
    jinner, tinner = jcnf.MLP((5, 8, 8, 3)), tcnf.MLP((5, 8, 8, 3))
    jw, tw = jcnf.CondLayer(jinner, jnp.asarray(ys)), tcnf.CondLayer(tinner, torch.from_numpy(ys))
    assert tw.n_in == jw.n_in == 3 and tw.n_out == jw.n_out == 3
    jparams = jax.device_get(jw.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams)
    x = _x((4, 3))
    out = tw.apply(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jw.apply(jparams, x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out, tinner.apply(tparams, torch.from_numpy(
        np.concatenate([x, np.broadcast_to(ys, (4, 2))], -1))).numpy(), rtol=1e-6)
    w2 = tcnf.CondLayer(tcnf.MLP((4, 8, 8, 3)), 0.25)
    assert w2.n_in == 3
    assert w2.apply(w2.init(torch.Generator().manual_seed(2), device="cpu"),
                    torch.from_numpy(x)).shape == (4, 3)
    with pytest.raises(ValueError, match="smaller than net input"):
        tcnf.CondLayer(tcnf.MLP((2, 4, 3)), torch.zeros(2))


def _torch_mlp(widths):
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        layers.append(torch.nn.Linear(a, b))
        if i < len(widths) - 2:
            layers.append(torch.nn.Softplus())
    return torch.nn.Sequential(*layers)


def test_from_torch_matches_mlp_and_from_flax():
    import flax.linen as fnn

    widths = (6, 24, 24, 5)

    class FlaxMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for i, w in enumerate(widths[1:]):
                x = fnn.Dense(w)(x)
                if i < len(widths) - 2:
                    x = jax.nn.softplus(x)
            return x

    jnet = jcnf.from_flax(FlaxMLP(), widths[0], widths[-1])
    fparams = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tnet = tcnf.from_torch(_torch_mlp(widths), widths[0], widths[-1])
    tparams = {}
    for i in range(len(widths) - 1):
        dense = fparams["params"][f"Dense_{i}"]
        tparams[f"{2 * i}.weight"] = torch.from_numpy(np.asarray(dense["kernel"]).T.copy())
        tparams[f"{2 * i}.bias"] = torch.from_numpy(np.array(dense["bias"]))
    x = _x((9, widths[0]))
    y_t = tnet.apply(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(jnet.apply(fparams, x)), rtol=1e-5, atol=1e-6)
    mlp = tcnf.MLP(widths)
    mlp_params = {f"layers.{i}.{n}": tparams[f"{2 * i}.{n}"]
                  for i in range(3) for n in ("weight", "bias")}
    np.testing.assert_allclose(y_t, mlp.apply(mlp_params, torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_from_torch_init_redraws_in_the_modules_own_scheme():
    """``init(generator)``: ``reset_parameters()`` on a CPU copy under the
    CPU RNG seeded from the generator; one seed one draw, the module and the
    global RNG untouched."""
    module = _torch_mlp((6, 24, 24, 5))
    before = {k: v.detach().clone() for k, v in module.named_parameters()}
    net = tcnf.from_torch(module, 6, 5)
    state = torch.random.get_rng_state()
    p1 = net.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    p2 = net.init(torch.Generator().manual_seed(0), device="cpu")
    p3 = net.init(torch.Generator().manual_seed(1), device="cpu")
    assert list(p1) == list(before)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["0.weight"], p3["0.weight"])
    assert all(torch.equal(v, before[k]) for k, v in module.named_parameters())
    bound = 1.0 / np.sqrt(6)  # nn.Linear's kaiming-uniform bound, fan_in 6
    assert float(p1["0.weight"].abs().max()) <= bound


@pytest.mark.parametrize("entry", ["Planar", "CondLayer", "from_torch"])
def test_new_nets_init_on_the_card_unless_asked_for_the_cpu(entry, monkeypatch):
    net = {"Planar": lambda: tcnf.Planar(3),
           "CondLayer": lambda: tcnf.CondLayer(tcnf.MLP((4, 8, 8, 3)), 0.5),
           "from_torch": lambda: tcnf.from_torch(_torch_mlp((3, 8, 3)), 3, 3)}[entry]()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        net.init(torch.Generator().manual_seed(0))
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(v.device.type == "cpu" for v in params.values())


DISTS = {
    "standard_normal": ((), ()),
    "diag_normal": (((0.5, -1.0, 0.0, 2.0, 0.1), (1.0, 0.5, 2.0, 0.3, 1.5)), None),
    "logistic": ((), ()),
    "student_t": ((7.5,), None),
    "student_t_df1.5": ((1.5,), None),
    "normal_mixture": (((-2.0, 1.0, 3.0), (0.5, 1.0, 0.7), (0.2, 0.5, 0.3)), None),
}


def _dist(pkg, name):
    args = DISTS[name][0]
    return getattr(pkg, name.split("_df")[0])(*args)


@pytest.mark.parametrize("name", list(DISTS))
def test_logpdf_matches_jax(name):
    z = 2.0 * _x((64, 5))
    z[0] = 0.0
    z[1] = 30.0  # far tails
    lp_j = np.asarray(_dist(jdists, name).logpdf(jnp.asarray(z)))
    lp_t = _dist(tdists, name).logpdf(torch.from_numpy(z)).numpy()
    assert lp_t.shape == (64,)
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-6, atol=1e-6)
    assert _dist(tdists, name) is _dist(tdists, name)  # lru_cached: one object


def _scipy_marginal(name, dim):
    """The distribution of dimension ``dim`` of a draw, as a scipy object."""
    if name == "standard_normal":
        return stats.norm()
    if name == "diag_normal":
        locs, scales = DISTS[name][0]
        return stats.norm(locs[dim], scales[dim])
    if name == "logistic":
        return stats.logistic()
    if name.startswith("student_t"):
        return stats.t(DISTS[name][0][0])
    if name == "uniform_probe":
        return stats.uniform(-np.sqrt(3.0), 2.0 * np.sqrt(3.0))
    locs, scales, weights = DISTS[name][0]
    w = np.asarray(weights) / sum(weights)

    class Mixture:
        def cdf(self, x):
            return sum(wi * stats.norm.cdf(x, m, s) for wi, m, s in zip(w, locs, scales))

        def mean(self):
            return float(np.dot(w, locs))

        def var(self):
            return float(np.dot(w, np.square(scales) + np.square(locs))) - self.mean() ** 2

    return Mixture()


@pytest.mark.parametrize("name", list(DISTS) + ["uniform_probe"])
def test_sampler_is_the_distribution(name):
    dist = tdists.uniform_probe() if name == "uniform_probe" else _dist(tdists, name)
    gen = torch.Generator().manual_seed(11)
    draws = dist.sample(gen, (N_DRAWS // 4, 4, 5), torch.float32)
    assert draws.shape == (N_DRAWS // 4, 4, 5) and draws.dtype == torch.float32
    assert torch.isfinite(draws).all()
    again = dist.sample(torch.Generator().manual_seed(11), (N_DRAWS // 4, 4, 5), torch.float32)
    assert torch.equal(draws, again)
    flat = draws.reshape(-1, 5).double().numpy()
    for dim in range(5):
        x = flat[:, dim]
        ref = _scipy_marginal(name, dim)
        assert stats.kstest(x, ref.cdf).pvalue > 1e-3, (name, dim)
        if name == "student_t_df1.5":
            continue  # infinite variance: the KS test alone
        n, mean, var = x.size, x.mean(), x.var()
        assert abs(mean - ref.mean()) < 4 * np.sqrt(var / n), (name, dim, mean)
        m4 = np.mean((x - mean) ** 4)
        assert abs(var - ref.var()) < 4 * np.sqrt((m4 - var ** 2) / n), (name, dim, var)


def test_steer_draw_has_shape_scalar():
    r = tdists.uniform_probe().sample(torch.Generator().manual_seed(0), (), torch.float32)
    assert r.shape == () and abs(float(r)) <= np.sqrt(3.0)


def test_custom_base_matches_jax_log_density():
    """A logistic base on the full model: TEST log-densities equal JAX's on
    the same params (the base enters only through ``base_logpdf``)."""
    jicnf = jcnf.ICNF.create(nvariables=2, base_dist=jdists.logistic())
    ticnf = tcnf.ICNF.create(nvariables=2, base_dist=tdists.logistic())
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    x = _x((16, 2))
    lp_j, _a, st_j = jcnf.inference(jicnf, JMode.TEST, x, jparams)
    lp_t, _a, st_t = tcnf.inference(ticnf, Mode.TEST, x, params_from_jax(jparams))
    assert tuple(int(v) for v in st_t[:3]) == tuple(int(v) for v in st_j[:3])
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5, atol=1e-5)


def test_custom_base_probe_and_steer_run_through_inference_and_loss():
    """A custom base, probe and steer each reach ``inference``, ``loss`` and
    the generate path; the probe and the end time come from their samplers."""
    steer = tcnf.CustomDist(None, lambda g, shape, dtype: torch.full(shape, 0.05, dtype=dtype),
                            "fixed_steer")
    icnf = tcnf.ICNF.create(nvariables=2, base_dist=tdists.student_t(5.0),
                            probe_dist=tdists.uniform_probe(), steer_dist=steer)
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    cfg = icnf.config
    assert float(tcore.steer_t1(cfg, torch.Generator(), "cpu")) == pytest.approx(1.05)
    eps = tcore.sample_probe(cfg, torch.Generator().manual_seed(1), 16, "cpu")
    assert eps.shape == (1, 16, 5) and float(eps.abs().max()) <= np.sqrt(3.0)
    assert len(torch.unique(eps)) > 40  # continuous, not Gaussian-enum Rademacher
    x = torch.from_numpy(_x((16, 2)))
    gen = lambda s: torch.Generator().manual_seed(s)
    for mode in (Mode.TEST, Mode.TRAIN):
        lp, _augs, _st = tcnf.inference(icnf, mode, x, params, gen(2))
        assert lp.shape == (16,) and torch.isfinite(lp).all()
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        l = tcnf.loss(icnf, mode, x, p, gen(3))
        grads = torch.autograd.grad(l, list(p.values()))
        assert torch.isfinite(l) and all(torch.isfinite(g).all() for g in grads)
    z = tcore.sample_base(cfg, gen(4), 4096, "cpu")
    assert stats.kstest(z[:, 0].numpy(), stats.t(5.0).cdf).pvalue > 1e-3
    s, lp = tcnf.ICNFDist(icnf, params, Mode.TRAIN, gen(5)).sample_with_logpdf(n=32)
    assert s.shape == (32, 2) and torch.isfinite(s).all() and torch.isfinite(lp).all()
