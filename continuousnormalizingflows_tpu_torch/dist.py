"""Distribution facade: a fitted ICNF as a probability distribution.

Counterpart of ``continuousnormalizingflows_tpu.dist``.  Where the JAX class
keeps a counter-split PRNG key, these keep a ``torch.Generator``: each
stochastic call without its own generator draws from the held one, so two
identical calls return different Hutchinson estimates; pass ``generator=``
for a reproducible one.  ``Mode.TEST`` (default) is exact and deterministic.
"""

from __future__ import annotations

import numbers
import warnings
from typing import Optional

import torch

from .config import Mode
from .core import _device_of, generate, generate_with_logp, inference
from .models.icnf import ICNF
from .models.multiscale import MultiscaleICNF
from .models.nets import Params
from .utils import profiling

__all__ = ["ICNFDist", "CondICNFDist"]


def _check_sample_args(what: str, n, generator) -> int:
    """The port's order is ``(n, generator=None)``, the reverse of the JAX
    package's ``(key, n)``: a call carried over by position gets an error
    that names it."""
    if (isinstance(n, bool) or not isinstance(n, numbers.Integral)
            or not (generator is None or isinstance(generator, torch.Generator))):
        raise TypeError(
            f"{what}(n, generator=None) takes the number of samples first and an optional "
            f"torch.Generator second (the reverse of the JAX package's {what}(key, n)); got "
            f"n={type(n).__name__}, generator={type(generator).__name__}"
        )
    return int(n)


def _shim_layout(x: torch.Tensor, nvariables: int) -> torch.Tensor:
    """A ``(nvariables, n)`` features-first batch is transposed to batch-first
    with a warning; any other width mismatch raises."""
    if x.ndim == 2 and x.shape[1] != nvariables and x.shape[0] == nvariables:
        warnings.warn(
            f"input looks features-first {tuple(x.shape)}; transposing to the "
            f"batch-first (n, {nvariables}) convention",
            stacklevel=3,
        )
        return x.T
    if x.ndim == 2 and x.shape[1] != nvariables:
        raise ValueError(
            f"input has {x.shape[1]} features but the model was built with "
            f"nvariables={nvariables} (got shape {tuple(x.shape)}; batch-first "
            f"(n, {nvariables}) expected)"
        )
    return x


class ICNFDist:
    """Unconditional flow distribution over ``nvariables`` dimensions.  Of a
    :class:`.models.multiscale.MultiscaleICNF`, ``logpdf`` only, in
    ``Mode.TRAIN_NOREG`` (it has no exact trace)."""

    def __init__(self, icnf: ICNF, params: Params, mode: Mode = Mode.TEST,
                 generator: Optional[torch.Generator] = None) -> None:
        self.icnf = icnf
        self.params = params
        self.mode = mode
        if generator is None:
            generator = torch.Generator(device=_device_of(params)).manual_seed(0)
        self.generator = generator

    def __len__(self) -> int:
        return self.icnf.config.nvariables

    def _ys_for(self, n: int):
        return None

    def logpdf(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-density; ``(d,)`` gives a scalar, ``(n, d)`` gives ``(n,)``."""
        with profiling.span("logpdf.call"):
            cfg = self.icnf.config
            x = torch.as_tensor(x, dtype=cfg.dtype, device=_device_of(self.params))
            x = _shim_layout(x, cfg.nvariables)
            if isinstance(self.icnf, MultiscaleICNF):
                return self.icnf.log_prob(self.mode, x, self.params, generator or self.generator)
            ys = self._ys_for(x.shape[0] if x.ndim > 1 else 1)
            logpx, _augs, _stats = inference(self.icnf, self.mode, x, self.params,
                                             generator or self.generator, ys)
            return logpx

    def pdf(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.exp(self.logpdf(x, generator))

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               trace_free: bool = False) -> torch.Tensor:
        """``(n, nvariables)`` samples; ``trace_free=True`` integrates only the
        bare field."""
        n = _check_sample_args("sample", n, generator)
        return generate(self.icnf, self.mode, self.params, generator or self.generator, n,
                        ys=self._ys_for(n), trace_free=trace_free)

    def sample_with_logpdf(self, n: int, generator: Optional[torch.Generator] = None):
        """``(samples, logpdf)`` from ONE reversed solve."""
        n = _check_sample_args("sample_with_logpdf", n, generator)
        return generate_with_logp(self.icnf, self.mode, self.params,
                                  generator or self.generator, n, ys=self._ys_for(n))

    rand = sample


class CondICNFDist(ICNFDist):
    """Conditional flow distribution at fixed conditions ``ys`` (broadcast or
    truncated to the query batch)."""

    def __init__(self, icnf: ICNF, params: Params, ys, mode: Mode = Mode.TEST,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(icnf, params, mode, generator)
        ys = torch.as_tensor(ys, dtype=icnf.config.dtype, device=_device_of(params))
        self.ys = ys[None, :] if ys.ndim == 1 else ys

    def _ys_for(self, n: int):
        if self.ys.shape[0] == n:
            return self.ys
        if self.ys.shape[0] == 1:
            return self.ys.expand(n, self.ys.shape[1])
        return self.ys[:n]
