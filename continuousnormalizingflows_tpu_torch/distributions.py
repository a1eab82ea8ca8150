"""Pluggable base and probe distributions.

Counterpart of ``continuousnormalizingflows_tpu.distributions``: a
distribution is a frozen ``(logpdf_fn, sample_fn)`` pair carried on the
config, used as ``ICNFConfig.base_dist`` (both callables), ``probe_dist``
(only ``sample_fn``) or ``steer_dist`` (only ``sample_fn``, drawn with shape
``()``)::

    from continuousnormalizingflows_tpu_torch import distributions as dists
    icnf = cnf.ICNF.create(nvariables=2, base_dist=dists.logistic())
    icnf = cnf.ICNF.create(nvariables=2, probe_dist=dists.uniform_probe())

``sample_fn(generator, shape, dtype)`` draws from the explicit
``torch.Generator`` on the generator's device (the JAX package's takes a
key first); the caller moves the draw to the data's device, so one seed
gives the same draw on every route.  ``logpdf_fn(z)`` maps ``(..., nz) ->
(...,)`` where ``z`` lies.

A ``probe_dist`` must have unit variance per component (the Hutchinson
estimator needs ``E[eps eps^T] = I``): of the factories here only
:func:`uniform_probe` is probe-ready as it is.  The factories are
``lru_cache``d, so equal arguments give the same object.  All are iid over
the ``nz`` dimensions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from .config import LOG_2PI

__all__ = [
    "CustomDist",
    "standard_normal",
    "diag_normal",
    "logistic",
    "student_t",
    "normal_mixture",
    "uniform_probe",
    "DefaultGenerator",
]


@dataclasses.dataclass(frozen=True)
class CustomDist:
    """A distribution as a static ``(logpdf, sample)`` callable pair:
    ``logpdf_fn(z)`` the joint log-density over the last axis,
    ``sample_fn(generator, shape, dtype)`` a draw of ``shape`` (the last axis
    is the event dimension ``nz``) on the generator's device.  A probe
    distribution may have ``logpdf_fn=None``."""

    logpdf_fn: Any
    sample_fn: Any
    name: str = "custom"

    def logpdf(self, z: torch.Tensor) -> torch.Tensor:
        return self.logpdf_fn(z)

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...], dtype) -> torch.Tensor:
        return self.sample_fn(generator, shape, dtype)


def _iid(name: str, logpdf1: Callable, sampler: Callable) -> CustomDist:
    """Lift a per-dimension log-density and a sampler to an iid joint."""
    return CustomDist(lambda z: torch.sum(logpdf1(z), dim=-1), sampler, name)


class DefaultGenerator:
    """Stands in for a ``torch.Generator`` where a traced program draws (the
    exported sampler): the draws take the default generator of ``device``,
    which the caller seeds (``torch.manual_seed`` under
    ``torch.random.fork_rng``).  A program cannot take a generator object."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)


def generator_arg(generator):
    """The ``generator=`` argument of a draw: None (the device's default
    generator) for a :class:`DefaultGenerator`, else ``generator``."""
    return None if isinstance(generator, DefaultGenerator) else generator


def _randn(generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator_arg(generator), dtype=dtype,
                       device=generator.device)


def _rand(generator, shape, dtype) -> torch.Tensor:
    return torch.rand(shape, generator=generator_arg(generator), dtype=dtype,
                      device=generator.device)


def _gamma_round(generator, shape, d: float, c: float, todo: torch.Tensor,
                 out: torch.Tensor):
    """One Marsaglia-Tsang round: a normal and a uniform for every element
    (drawn in that order), the elements still ``todo`` that accept take
    ``d v``.  Returns the new ``(todo, out)``."""
    x = _randn(generator, shape, torch.float64)
    u = _rand(generator, shape, torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.clamp(v, min=1e-300)))
    return todo & ~ok, torch.where(todo & ok, d * v, out)


def _gamma(generator: torch.Generator, shape, alpha: float) -> torch.Tensor:
    """Gamma(alpha, 1) draws in float64 by Marsaglia and Tsang's squeeze-free
    rejection (every element redrawn until accepted, > 95 % a round), with
    ``Gamma(alpha) = Gamma(alpha + 1) U^(1 / alpha)`` below ``alpha = 1``.
    Exact: the rounds run until every element has accepted.  Eagerly a round
    ends in a host read of whether any element is left; a traced program's
    draws (a :class:`DefaultGenerator`) run the same rounds in a
    ``while_loop`` whose carry is the mask and the output, so one seed gives
    the same bits both ways."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float64, device=generator.device)
    todo = torch.ones(shape, dtype=torch.bool, device=generator.device)
    step = lambda todo, out: _gamma_round(generator, shape, d, c, todo, out)
    if isinstance(generator, DefaultGenerator):
        from torch._higher_order_ops.while_loop import while_loop

        todo, out = while_loop(lambda todo, _out: todo.any(), step, (todo, out))
    else:
        while bool(todo.any()):
            todo, out = step(todo, out)
    if alpha < 1.0:
        out = out * _rand(generator, shape, torch.float64) ** (1.0 / alpha)
    return out


@functools.lru_cache(maxsize=None)
def standard_normal() -> CustomDist:
    """The reference default base, ``MvNormal(0, I)``: the built-in fast path
    (``base_dist=None``) as an explicit distribution."""
    return _iid("standard_normal", lambda z: -0.5 * (LOG_2PI + torch.square(z)), _randn)


@functools.lru_cache(maxsize=None)
def diag_normal(locs: Tuple[float, ...], scales: Tuple[float, ...]) -> CustomDist:
    """An independent normal per dimension with the given means and scales
    (float tuples of length ``nz``)."""
    if len(locs) != len(scales):
        raise ValueError(f"locs/scales length mismatch: {len(locs)} vs {len(scales)}")
    if not all(s > 0.0 for s in scales):
        raise ValueError(f"scales must be positive, got {scales}")

    def logpdf_fn(z):
        mu = torch.tensor(locs, dtype=z.dtype, device=z.device)
        sig = torch.tensor(scales, dtype=z.dtype, device=z.device)
        r = (z - mu) / sig
        return torch.sum(-0.5 * (LOG_2PI + r * r) - torch.log(sig), dim=-1)

    def sample_fn(generator, shape, dtype):
        if shape[-1] != len(locs):
            raise ValueError(
                f"diag_normal built for {len(locs)} dims, asked for {shape[-1]} "
                f"(nz must match the distribution width)"
            )
        mu = torch.tensor(locs, dtype=dtype, device=generator.device)
        sig = torch.tensor(scales, dtype=dtype, device=generator.device)
        return mu + sig * _randn(generator, shape, dtype)

    return CustomDist(logpdf_fn, sample_fn, "diag_normal")


@functools.lru_cache(maxsize=None)
def logistic() -> CustomDist:
    """iid standard logistic, a heavier-tailed base (kurtosis 4.2)."""

    def sample_fn(generator, shape, dtype):
        u = torch.clamp(_rand(generator, shape, dtype), min=torch.finfo(dtype).tiny)
        return torch.log(u) - torch.log1p(-u)

    # log f(z) = -z - 2 log(1 + e^-z)
    return _iid("logistic", lambda z: -z - 2.0 * F.softplus(-z), sample_fn)


@functools.lru_cache(maxsize=None)
def student_t(df: float) -> CustomDist:
    """iid Student-t with ``df`` degrees of freedom.  A draw is ``N /
    sqrt(X / df)`` with ``X = 2 Gamma(df / 2)``, a chi-square, both from the
    generator."""
    if not df > 0.0:
        raise ValueError(f"df must be positive, got {df}")
    c = float(math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0)
              - 0.5 * math.log(df * math.pi))

    def sample_fn(generator, shape, dtype):
        chi2 = 2.0 * _gamma(generator, shape, df / 2.0)
        return (_randn(generator, shape, torch.float64) / torch.sqrt(chi2 / df)).to(dtype)

    return _iid(f"student_t({df})",
                lambda z: c - 0.5 * (df + 1.0) * torch.log1p(torch.square(z) / df), sample_fn)


@functools.lru_cache(maxsize=None)
def normal_mixture(locs: Tuple[float, ...], scales: Tuple[float, ...],
                   weights: Tuple[float, ...]) -> CustomDist:
    """iid per-dimension K-component normal mixture (a multimodal base);
    float tuples of length K, the weights normalized here.  A draw picks its
    component with ``torch.multinomial`` on the generator."""
    k = len(locs)
    if len(scales) != k or len(weights) != k:
        raise ValueError("locs/scales/weights must have equal length")
    if not all(s > 0.0 for s in scales):
        raise ValueError(f"scales must be positive, got {scales}")
    if not all(w > 0.0 for w in weights):
        raise ValueError(f"weights must be positive, got {weights}")
    wsum = float(sum(weights))
    logw = tuple(math.log(w / wsum) for w in weights)

    def logpdf_fn(z):
        mu = torch.tensor(locs, dtype=z.dtype, device=z.device)
        sig = torch.tensor(scales, dtype=z.dtype, device=z.device)
        lw = torch.tensor(logw, dtype=z.dtype, device=z.device)
        r = (z[..., None] - mu) / sig  # (..., nz, K)
        comp = -0.5 * (LOG_2PI + r * r) - torch.log(sig) + lw
        return torch.sum(torch.logsumexp(comp, dim=-1), dim=-1)

    def sample_fn(generator, shape, dtype):
        dev = generator.device
        probs = torch.tensor([w / wsum for w in weights], dtype=torch.float64, device=dev)
        n = math.prod(shape)
        idx = torch.multinomial(probs, max(n, 1), replacement=True,
                                generator=generator_arg(generator))[:n].reshape(shape)
        mu = torch.tensor(locs, dtype=dtype, device=dev)[idx]
        sig = torch.tensor(scales, dtype=dtype, device=dev)[idx]
        return mu + sig * _randn(generator, shape, dtype)

    return CustomDist(logpdf_fn, sample_fn, "normal_mixture")


@functools.lru_cache(maxsize=None)
def uniform_probe() -> CustomDist:
    """Sampling-only probe: uniform on ``[-sqrt(3), sqrt(3)]``, unit variance,
    so the Hutchinson estimator stays unbiased."""
    s = math.sqrt(3.0)
    return CustomDist(None, lambda generator, shape, dtype: (
        2.0 * s * _rand(generator, shape, dtype) - s), "uniform_probe")
