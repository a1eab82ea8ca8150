"""Toy data: the 2-D ring-of-Gaussians mixture and its exact log-density.

Counterpart of ``gaussian_mixture`` / ``gaussian_mixture_logpdf`` in
``continuousnormalizingflows_tpu.utils.datasets``; the other generators there
come with the ROADMAP's Queue 1 item on utils.
"""

from __future__ import annotations

import math

import torch

__all__ = ["gaussian_mixture", "gaussian_mixture_logpdf"]


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
