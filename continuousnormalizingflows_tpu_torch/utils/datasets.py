"""Data: the toy generators, the smooth-image mixture with its exact density,
the digits pipeline and the real tabular tables.

Counterpart of ``continuousnormalizingflows_tpu.utils.datasets``.  Where the
JAX package takes a PRNG key, a draw here takes a ``torch.Generator`` and
happens on the generator's device; what a draw feeds into the arithmetic
enters through one helper that takes the draws as tensors
(:func:`_dequantize_logit_u`, :func:`_shift_images`), so a test can feed it
the JAX package's draws.

sklearn is imported inside the functions that read its bundled tables
(:func:`digits_data`, :func:`digits_split`, :func:`load_tabular_real`); where
it is not installed they raise its ``ImportError``, with no substitute
data.  Those three return CPU tensors (the digits images as numpy, as the
JAX package does).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import LOG_2PI
from ..distributions import _gamma

__all__ = [
    "beta_samples",
    "beta_pdf",
    "gaussian_mixture",
    "gaussian_mixture_logpdf",
    "two_moons",
    "circles",
    "smooth_image_mixture",
    "smooth_image_mixture_logpdf",
    "nats_to_bits_per_dim",
    "digits_data",
    "DIGITS_LEVELS",
    "dequantize_logit",
    "logit_to_levels",
    "digits_split",
    "digits_standardizer",
    "diagonal_gaussian_logp",
    "quantized_bits_per_dim",
    "load_tabular_real",
    "random_shift_images",
]

_LN2 = 0.6931471805599453


def beta_samples(generator: torch.Generator, n: int, a: float = 2.0, b: float = 4.0,
                 ndim: int = 1) -> torch.Tensor:
    """``(n, ndim)`` i.i.d. Beta(a, b) samples (the reference regression
    config): ``G_a / (G_a + G_b)`` of two Marsaglia-Tsang gamma draws in
    float64, on the generator's device."""
    ga = _gamma(generator, (n, ndim), a)
    gb = _gamma(generator, (n, ndim), b)
    return (ga / (ga + gb)).to(torch.float32)


def beta_pdf(x: torch.Tensor, a: float = 2.0, b: float = 4.0) -> torch.Tensor:
    """Beta(a, b) pdf elementwise (ground truth for parity checks)."""
    betaln = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    return torch.exp((a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - betaln)


def _ring_means(k: int, radius: float, device=None) -> torch.Tensor:
    ang = torch.arange(k, dtype=torch.float32, device=device) * (2 * math.pi / k)
    return radius * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def gaussian_mixture(generator: torch.Generator, n: int, k: int = 8,
                     radius: float = 2.0, std: float = 0.3) -> torch.Tensor:
    """``(n, 2)`` samples from a k-mode ring-of-Gaussians mixture, drawn on the
    generator's device."""
    dev = generator.device
    comp = torch.randint(0, k, (n,), generator=generator, device=dev)
    noise = torch.randn((n, 2), generator=generator, device=dev)
    return _ring_means(k, radius, dev)[comp] + std * noise


def gaussian_mixture_logpdf(x: torch.Tensor, k: int = 8, radius: float = 2.0,
                            std: float = 0.3) -> torch.Tensor:
    means = _ring_means(k, radius, x.device).to(x.dtype)
    d2 = torch.sum(torch.square(x[..., None, :] - means), dim=-1)  # (..., k)
    comp_logp = -0.5 * d2 / std**2 - math.log(2 * math.pi * std**2)
    return torch.logsumexp(comp_logp, dim=-1) - math.log(k)


def _side_angle_noise(generator: torch.Generator, n: int, max_angle: float):
    """The draws of the two 2-D toys: a fair side, an angle in ``[0,
    max_angle)`` and 2-D standard-normal noise."""
    dev = generator.device
    side = torch.rand((n,), generator=generator, device=dev) < 0.5
    theta = max_angle * torch.rand((n,), generator=generator, device=dev)
    return side, theta, torch.randn((n, 2), generator=generator, device=dev)


def two_moons(generator: torch.Generator, n: int, noise: float = 0.08) -> torch.Tensor:
    """``(n, 2)`` two-interleaving-moons samples."""
    side, theta, eps = _side_angle_noise(generator, n, math.pi)
    x = torch.where(side, torch.cos(theta), 1.0 - torch.cos(theta))
    y = torch.where(side, torch.sin(theta), 0.5 - torch.sin(theta))
    return torch.stack([x, y], dim=-1) + noise * eps


def circles(generator: torch.Generator, n: int, factor: float = 0.5,
            noise: float = 0.05) -> torch.Tensor:
    """``(n, 2)`` two-concentric-circles samples."""
    side, theta, eps = _side_angle_noise(generator, n, 2 * math.pi)
    r = torch.where(side, 1.0, factor)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1) + noise * eps


# ---------------------------------------------------------------------------
# image-scale synthetic task with a known likelihood: a mixture of smooth
# Gaussian random fields over the pixel grid, each N(mu_k, Sigma_k) with an
# RBF covariance (its own correlation length) plus 0.05 i.i.d. pixel noise
# around a low-frequency mean pattern (see the JAX package's module for the
# reasoning behind the choice)
# ---------------------------------------------------------------------------


def _rbf_chol_np(side: int, lengthscale: float, var: float, jitter: float = 0.05):
    idx = np.arange(side, dtype=np.float64)
    gx, gy = np.meshgrid(idx, idx, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    cov = var * np.exp(-d2 / (2.0 * lengthscale**2)) + jitter * np.eye(side * side)
    return np.linalg.cholesky(cov)


@functools.lru_cache(maxsize=8)
def _image_mixture_np(side: int, ncomp: int):
    """``(means (k, d), chols (k, d, d))`` as float32 numpy, computed once per
    ``(side, ncomp)``."""
    lengthscales = (1.2, 2.5, 5.0, 1.8, 3.5)[:ncomp]
    idx = np.arange(side, dtype=np.float64) / side
    gx, gy = np.meshgrid(idx, idx, indexing="ij")
    patterns = [
        1.5 * np.sin(2 * np.pi * gx),
        1.5 * np.cos(2 * np.pi * gy),
        1.5 * np.sin(2 * np.pi * (gx + gy)),
        1.5 * np.cos(4 * np.pi * gx) * np.sin(2 * np.pi * gy),
        -1.5 * np.sin(4 * np.pi * gy),
    ][:ncomp]
    means = np.stack([p.ravel() for p in patterns]).astype(np.float32)
    chols = np.stack([_rbf_chol_np(side, l, 1.0) for l in lengthscales]).astype(np.float32)
    means.flags.writeable = chols.flags.writeable = False
    return means, chols


def _image_mixture_components(side: int, ncomp: int, device=None):
    """``(means (k, d), chols (k, d, d))``, float32 on ``device``."""
    means, chols = _image_mixture_np(side, ncomp)
    return torch.tensor(means, device=device), torch.tensor(chols, device=device)


def smooth_image_mixture(generator: torch.Generator, n: int, side: int = 28,
                         ncomp: int = 3) -> torch.Tensor:
    """``(n, side*side)`` samples from the smooth-image mixture, on the
    generator's device."""
    dev = generator.device
    means, chols = _image_mixture_components(side, ncomp, dev)
    comp = torch.randint(0, ncomp, (n,), generator=generator, device=dev)
    xi = torch.randn((n, side * side), generator=generator, device=dev)
    # one (n, d) x (d, d) product per component and a select: never a
    # per-sample (d, d) Cholesky gather (40 GB at d = 784, n = 16k)
    noise = torch.zeros_like(xi)
    for k in range(ncomp):
        noise = torch.where((comp == k)[:, None], xi @ chols[k].t(), noise)
    return means[comp] + noise


def smooth_image_mixture_logpdf(x: torch.Tensor, side: int = 28, ncomp: int = 3) -> torch.Tensor:
    """Exact log-density of the mixture, ``x``: ``(n, side*side)``."""
    means, chols = _image_mixture_components(side, ncomp, x.device)
    d = side * side
    lps = []
    for mu, chol in zip(means.to(x.dtype), chols.to(x.dtype)):
        z = torch.linalg.solve_triangular(chol, (x - mu).t(), upper=False)  # (d, n)
        logdet = torch.sum(torch.log(torch.diagonal(chol)))
        lps.append(-0.5 * (d * LOG_2PI + torch.sum(z * z, dim=0)) - logdet)
    return torch.logsumexp(torch.stack(lps), dim=0) - math.log(ncomp)


def nats_to_bits_per_dim(nll_nats, d: int):
    """bits/dim = NLL_nats / (d * ln 2), the image-modelling convention."""
    return nll_nats / (d * _LN2)


# ---------------------------------------------------------------------------
# real image data: sklearn's handwritten digits, with uniform dequantization
# and the logit transform
# ---------------------------------------------------------------------------


def digits_data() -> np.ndarray:
    """The 1,797 real 8x8 handwritten-digit images (UCI, bundled with
    sklearn) as an ``(n, 64)`` float array of gray levels 0..16."""
    from sklearn.datasets import load_digits

    return load_digits().data


DIGITS_LEVELS = 17  # gray levels in the digits data: {0, 1, ..., 16}


def _dequantize_logit_u(x_int: torch.Tensor, u: torch.Tensor, levels: int,
                        alpha: float):
    """:func:`dequantize_logit` for given uniforms ``u`` (the shape of
    ``x_int``)."""
    z = (x_int + u) / levels
    s = alpha + (1.0 - 2.0 * alpha) * z
    y = torch.log(s) - torch.log1p(-s)
    ldj = torch.sum(math.log(1.0 - 2.0 * alpha) - torch.log(s) - torch.log1p(-s), dim=-1)
    return y, ldj


def dequantize_logit(x_int: torch.Tensor, generator: torch.Generator,
                     levels: int = DIGITS_LEVELS, alpha: float = 0.05):
    """Uniform dequantization and the logit transform (the FFJORD/RealNVP
    image preprocessing): ``z = (x + u) / levels`` with ``u ~ U(0, 1)`` per
    pixel, then ``y = logit(alpha + (1 - 2 alpha) z)``.  Returns ``(y,
    ldj)``, ``ldj`` the per-sample ``sum log dy/dz``."""
    u = torch.rand(x_int.shape, generator=generator, dtype=torch.float32,
                   device=generator.device).to(x_int.device)
    return _dequantize_logit_u(x_int, u, levels, alpha)


def logit_to_levels(y: torch.Tensor, levels: int = DIGITS_LEVELS,
                    alpha: float = 0.05) -> torch.Tensor:
    """Inverse of :func:`dequantize_logit` back to gray levels ``[0, levels -
    1]`` (for rendering generated samples)."""
    z = (torch.sigmoid(y) - alpha) / (1.0 - 2.0 * alpha)
    return torch.clamp(z * levels, 0.0, levels - 1.0)


def digits_split(n_train: int = 1500, seed: int = 42, with_labels: bool = False):
    """Shuffled digits train/test split, float32 CPU tensors; with
    ``with_labels`` also the 0-9 class labels: ``(x_tr, x_te, y_tr, y_te)``.
    The permutation is ``torch.randperm`` on a CPU generator seeded with
    ``seed``: the same sizes as the JAX package's split, other images in
    each half (its permutation comes from threefry)."""
    from sklearn.datasets import load_digits

    ds = load_digits()
    x_all = torch.tensor(np.asarray(ds.data, np.float32))
    perm = torch.randperm(len(x_all), generator=torch.Generator().manual_seed(seed))
    xs = x_all[perm[:n_train]], x_all[perm[n_train:]]
    if not with_labels:
        return xs
    labels = torch.tensor(np.asarray(ds.target, np.int32))
    return xs + (labels[perm[:n_train]], labels[perm[n_train:]])


def _standardizer_from_logits(y0: torch.Tensor):
    """``(m, s, log_s_sum)`` of drawn train logits ``y0``."""
    m = torch.mean(y0, dim=0)
    s = torch.std(y0, dim=0, correction=0) + 1e-3
    return m, s, float(torch.sum(torch.log(s)))


def digits_standardizer(x_train_i: torch.Tensor, alpha: float = 0.05, seed: int = 7):
    """Per-dim standardization constants from one train dequantization draw
    (a fixed diagonal affine layer of the model; its log|det| enters the
    likelihood), the draw on a generator seeded with ``seed`` on the data's
    device.  Returns ``(m, s, log_s_sum, y0)``, ``y0`` the drawn logits."""
    gen = torch.Generator(device=x_train_i.device).manual_seed(seed)
    y0, _ = dequantize_logit(x_train_i, gen, alpha=alpha)
    return (*_standardizer_from_logits(y0), y0)


def diagonal_gaussian_logp(y_train: torch.Tensor, y_test: torch.Tensor) -> torch.Tensor:
    """Log-density of test points under a diagonal Gaussian fitted on train:
    the yardstick real data has in place of an analytic pdf."""
    mu = torch.mean(y_train, dim=0)
    v = torch.var(y_train, dim=0, correction=0) + 1e-6
    return -0.5 * torch.sum(torch.log(2 * math.pi * v) + (y_test - mu) ** 2 / v, dim=-1)


def quantized_bits_per_dim(logp_y, ldj, d: int, levels: int = DIGITS_LEVELS):
    """bits/dim of the quantized data under the dequantization bound, with
    ``log p_z = log p_y + ldj``; ``log2(levels)`` is a uniform model's."""
    return -(logp_y + ldj) / (d * _LN2) + math.log2(float(levels))


def load_tabular_real(name: str, seed: int = 0, test_frac: float = 0.2,
                      jitter: float = 0.02):
    """Real UCI tables bundled with sklearn (``wine`` 178x13,
    ``breast_cancer`` 569x30, ``diabetes`` 442x9 with the binary sex column
    dropped): z-scored on train statistics, Gaussian jitter, shuffle-split,
    all in numpy with ``default_rng(seed)``, so the tables equal the JAX
    package's bit for bit.  Returns ``(x_train, x_test)``, float32 CPU
    tensors."""
    from sklearn import datasets as skd

    loaders = {
        "wine": skd.load_wine,
        "breast_cancer": skd.load_breast_cancer,
        "diabetes": lambda: skd.load_diabetes(scaled=False),
    }
    if name not in loaders:
        raise ValueError(f"unknown tabular dataset {name!r}; use {sorted(loaders)}")
    x = np.asarray(loaders[name]().data, dtype=np.float64)
    if name == "diabetes":
        x = np.delete(x, 1, axis=1)
    rng = np.random.default_rng(seed)
    x = x[rng.permutation(x.shape[0])]
    n_test = max(1, int(round(test_frac * x.shape[0])))
    xte, xtr = x[:n_test], x[n_test:]
    m, s = xtr.mean(0), xtr.std(0) + 1e-6
    xtr = (xtr - m) / s + jitter * rng.standard_normal(xtr.shape)
    xte = (xte - m) / s + jitter * rng.standard_normal(xte.shape)
    return torch.tensor(xtr.astype(np.float32)), torch.tensor(xte.astype(np.float32))


def _shift_images(x_int: torch.Tensor, side: int, dy: torch.Tensor, dx: torch.Tensor,
                  on=None) -> torch.Tensor:
    """:func:`random_shift_images` for given integer shifts ``dy``, ``dx``
    ``(B,)`` and, where only a fraction is shifted, the 0/1 mask ``on``."""
    if on is not None:
        dy, dx = dy * on, dx * on
    b = x_int.shape[0]
    imgs = x_int.reshape(b, side, side)
    ar = torch.arange(side, device=x_int.device)
    rows = ar[None, :, None] - dy[:, None, None]  # (b, s, 1)
    cols = ar[None, None, :] - dx[:, None, None]  # (b, 1, s)
    valid = (rows >= 0) & (rows < side) & (cols >= 0) & (cols < side)
    r = torch.clamp(rows, 0, side - 1).expand(b, side, side)
    c = torch.clamp(cols, 0, side - 1).expand(b, side, side)
    shifted = torch.gather(torch.gather(imgs, 1, r), 2, c)
    return torch.where(valid, shifted, torch.zeros_like(shifted)).reshape(b, side * side)


def random_shift_images(generator: torch.Generator, x_int: torch.Tensor, side: int,
                        max_shift: int = 1, prob: float = 1.0) -> torch.Tensor:
    """Per-sample random integer translation of flattened ``(B, side*side)``
    images, zero fill (the digits background), the standard small-image
    augmentation; with ``prob < 1`` only that fraction of samples moves.  The
    signature is ``ICNFModel.fit``'s ``batch_transform``: pass
    ``functools.partial(random_shift_images, side=8)`` (fresh shifts every
    step)."""
    b = x_int.shape[0]
    dev = generator.device
    dy = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator, device=dev)
    dx = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator, device=dev)
    on = None
    if prob < 1.0:
        on = (torch.rand((b,), generator=generator, device=dev) < prob).to(dy.dtype)
    to = lambda v: None if v is None else v.to(x_int.device)
    return _shift_images(x_int, side, to(dy), to(dx), to(on))
