"""The port's datasets against the JAX package's.

Deterministic functions on the same numpy inputs: elementwise float32
arithmetic to rtol 1e-6 (the same operations, other libm), the smooth-image
mixture's log-density to rtol 1e-5 (a triangular solve and a sum over d
pixels in another order).  The functions with draws take the JAX package's
own draws through the port's helper (``_dequantize_logit_u``,
``_shift_images``): the dequantization to rtol 1e-6, the shifted images
exactly.  The sklearn tables equal the JAX package's bit for bit (the same
numpy code).  The samplers draw from other generators, so they are held by
their moments against the JAX samplers' at n = 20,000, each to about five
standard errors, and the beta also by a KS test against scipy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from continuousnormalizingflows_tpu.utils import datasets as jd
from continuousnormalizingflows_tpu_torch.utils import datasets as td

N = 20_000


def _np(t):
    return t.detach().cpu().numpy()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- deterministic functions ----

def test_beta_pdf_matches_jax():
    x = np.linspace(-0.1, 1.1, 101, dtype=np.float32)
    for a, b in ((2.0, 4.0), (0.5, 0.5), (3.0, 1.5)):
        np.testing.assert_allclose(_np(td.beta_pdf(torch.tensor(x), a, b)),
                                   np.asarray(jd.beta_pdf(jnp.asarray(x), a, b)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", [4, 6])
def test_image_mixture_components_match_jax(side):
    jm, jc = jd._image_mixture_components(side, 3)
    tm, tc = td._image_mixture_components(side, 3)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))


@pytest.mark.parametrize("side", [4, 6])
def test_smooth_image_mixture_logpdf_matches_jax(side):
    x = np.random.default_rng(side).standard_normal((64, side * side)).astype(np.float32)
    np.testing.assert_allclose(_np(td.smooth_image_mixture_logpdf(torch.tensor(x), side)),
                               np.asarray(jd.smooth_image_mixture_logpdf(jnp.asarray(x), side)),
                               rtol=1e-5)


def test_nats_to_bits_and_quantized_bits_match_jax():
    rng = np.random.default_rng(0)
    nll = rng.uniform(10, 100, 32).astype(np.float32)
    ldj = rng.normal(-50, 5, 32).astype(np.float32)
    np.testing.assert_allclose(_np(td.nats_to_bits_per_dim(torch.tensor(nll), 64)),
                               np.asarray(jd.nats_to_bits_per_dim(jnp.asarray(nll), 64)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _np(td.quantized_bits_per_dim(torch.tensor(-nll), torch.tensor(ldj), 64)),
        np.asarray(jd.quantized_bits_per_dim(jnp.asarray(-nll), jnp.asarray(ldj), 64)),
        rtol=1e-6)


def test_logit_to_levels_matches_jax():
    y = np.random.default_rng(1).normal(0, 3, (16, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(td.logit_to_levels(torch.tensor(y))),
                               np.asarray(jd.logit_to_levels(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)


def test_standardizer_and_gaussian_baseline_match_jax():
    """Given JAX's drawn logits ``y0``: the standardization constants, and
    the diagonal-Gaussian yardstick on a test split."""
    x_int = np.random.default_rng(2).integers(0, 17, (200, 64)).astype(np.float32)
    jm, js, jlog, jy0 = jd.digits_standardizer(jnp.asarray(x_int))
    tm, ts, tlog = td._standardizer_from_logits(torch.tensor(np.asarray(jy0)))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-6)
    assert tlog == pytest.approx(jlog, rel=1e-6)
    y_tr, y_te = np.asarray(jy0[:150]), np.asarray(jy0[150:])
    np.testing.assert_allclose(
        _np(td.diagonal_gaussian_logp(torch.tensor(y_tr), torch.tensor(y_te))),
        np.asarray(jd.diagonal_gaussian_logp(jnp.asarray(y_tr), jnp.asarray(y_te))),
        rtol=1e-5)


def test_digits_standardizer_draws_on_the_data_device():
    x_int = torch.randint(0, 17, (50, 64), generator=_gen(0)).float()
    m, s, log_s, y0 = td.digits_standardizer(x_int)
    assert y0.shape == (50, 64) and m.shape == s.shape == (64,)
    assert log_s == pytest.approx(float(torch.log(s).sum()))
    torch.testing.assert_close(td.digits_standardizer(x_int)[3], y0, rtol=0, atol=0)


# ---- functions with draws, fed the JAX package's draws ----

def test_dequantize_logit_matches_jax_with_its_draws():
    x_int = np.random.default_rng(3).integers(0, 17, (32, 64)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jy, jldj = jd.dequantize_logit(jnp.asarray(x_int), key)
    u = np.asarray(jax.random.uniform(key, x_int.shape, dtype=jnp.float32))
    ty, tldj = td._dequantize_logit_u(torch.tensor(x_int), torch.tensor(u), jd.DIGITS_LEVELS,
                                      0.05)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tldj), np.asarray(jldj), rtol=1e-6)
    # the port's own draw: the same transform of uniforms in [0, 1)
    y, ldj = td.dequantize_logit(torch.tensor(x_int), _gen(0))
    z = torch.sigmoid(y)
    assert y.shape == (32, 64) and ldj.shape == (32,)
    assert bool(((z - 0.05) / 0.9 * 17 >= torch.tensor(x_int) - 1e-4).all())


@pytest.mark.parametrize("max_shift,prob", [(1, 1.0), (2, 1.0), (1, 0.5)],
                         ids=["shift1", "shift2", "half"])
def test_random_shift_images_matches_jax_with_its_draws(max_shift, prob):
    side, b = 8, 40
    x_int = np.random.default_rng(4).integers(0, 17, (b, side * side)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jd.random_shift_images(key, jnp.asarray(x_int), side, max_shift, prob)
    k1, k2, k3 = jax.random.split(key, 3)
    dy = np.asarray(jax.random.randint(k1, (b,), -max_shift, max_shift + 1))
    dx = np.asarray(jax.random.randint(k2, (b,), -max_shift, max_shift + 1))
    on = None
    if prob < 1.0:
        on = torch.tensor(np.asarray(jax.random.bernoulli(k3, prob, (b,))).astype(dy.dtype))
    got = td._shift_images(torch.tensor(x_int), side, torch.tensor(dy), torch.tensor(dx), on)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the port's own draw: every image a shifted copy, zero filled
    out = td.random_shift_images(_gen(1), torch.tensor(x_int), side, max_shift, prob)
    assert out.shape == x_int.shape and out.dtype == torch.float32
    assert bool((out.sum(1) <= torch.tensor(x_int).sum(1) + 1e-3).all())


# ---- the sklearn tables ----

@pytest.mark.parametrize("name", ["wine", "breast_cancer", "diabetes"])
def test_load_tabular_real_equals_jax_bit_for_bit(name):
    for got, want in zip(td.load_tabular_real(name, seed=3), jd.load_tabular_real(name, seed=3)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_load_tabular_real_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown tabular dataset"):
        td.load_tabular_real("iris")


def test_digits_data_and_split():
    np.testing.assert_array_equal(td.digits_data(), jd.digits_data())
    x_tr, x_te, y_tr, y_te = td.digits_split(with_labels=True)
    jx_tr, jx_te = jd.digits_split()
    assert x_tr.shape == tuple(jx_tr.shape) == (1500, 64)
    assert x_te.shape == tuple(jx_te.shape) == (297, 64)
    assert y_tr.shape == (1500,) and y_te.shape == (297,)
    # disjoint halves whose union is every image (rows as multisets)
    rows = lambda a: sorted(map(tuple, np.asarray(a).tolist()))
    assert rows(torch.cat([x_tr, x_te])) == rows(td.digits_data().astype(np.float32))
    # the label of each row is the dataset's label of that image
    from sklearn.datasets import load_digits

    ds = load_digits()
    perm = torch.randperm(1797, generator=_gen(42))
    np.testing.assert_array_equal(_np(y_tr), ds.target[_np(perm[:1500])])
    torch.testing.assert_close(td.digits_split()[0], x_tr, rtol=0, atol=0)


# ---- samplers: moments against the JAX samplers ----

def _moments_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=tol)
    np.testing.assert_allclose(np.cov(got.T), np.cov(want.T), atol=2 * tol)


def test_beta_samples_moments_and_ks():
    got = _np(td.beta_samples(_gen(0), N))
    want = np.asarray(jd.beta_samples(jax.random.PRNGKey(0), N))
    assert got.shape == (N, 1) and got.dtype == np.float32
    # sd 0.178: the standard error of a mean is 1.3e-3
    _moments_close(got, want, 0.009)
    assert scipy.stats.kstest(got[:, 0], scipy.stats.beta(2, 4).cdf).pvalue > 1e-3
    assert scipy.stats.kstest(_np(td.beta_samples(_gen(1), N, 0.5, 0.7))[:, 0],
                              scipy.stats.beta(0.5, 0.7).cdf).pvalue > 1e-3


@pytest.mark.parametrize("name", ["two_moons", "circles"])
def test_2d_toys_moments(name):
    got = _np(getattr(td, name)(_gen(0), N))
    want = np.asarray(getattr(jd, name)(jax.random.PRNGKey(0), N))
    assert got.shape == (N, 2)
    # coordinates of sd <= 0.9: a mean's standard error <= 6.4e-3
    _moments_close(got, want, 0.03)


def test_smooth_image_mixture_moments():
    side = 4
    got = td.smooth_image_mixture(_gen(0), N, side)
    want = np.asarray(jd.smooth_image_mixture(jax.random.PRNGKey(0), N, side))
    assert got.shape == (N, side * side)
    # pixels of sd <= 1.6: a mean's standard error <= 0.012
    _moments_close(_np(got), want, 0.06)
    # the mean log-density under the exact pdf (sd ~ 3 nats: SE 0.02)
    lp_got = float(td.smooth_image_mixture_logpdf(got, side).mean())
    lp_want = float(jd.smooth_image_mixture_logpdf(jnp.asarray(want), side).mean())
    assert lp_got == pytest.approx(lp_want, abs=0.1)
