"""FFJORD's multiscale continuous normalizing flow (``ODENVP``, ``lib/odenvp.py``
of github.com/rtqichen/ffjord) as a chain of ICNF blocks.

The port's own model, with no JAX counterpart.  On an image of shape ``(c,
h, w)`` (rows flattened to ``c*h*w`` columns, each in ``[0, 1]``: the
dequantised pixels, which the caller's ``batch_transform`` makes, as
FFJORD's ``add_noise``; :func:`dequantize` is that transform for 8-bit
values):

1. the logit ``y = logit(s)``, ``s = alpha + (1 - 2 alpha) x``, which adds
   ``sum log((1 - 2 alpha) / (s (1 - s)))`` to the log-density;
2. scales ``k = 0 .. K-1`` (``K`` FFJORD's ``_calc_n_scale``: one a halving
   while both sides are at least 4): ``nblocks`` blocks on ``(c, h, w)``;
   then, on every scale but the last, :func:`squeeze` to ``(4c, h/2, w/2)``,
   ``nblocks`` blocks more, and the channels ``[2c:4c]`` factored out to a
   standard normal; the next scale starts on ``(2c, h/2, w/2)``;
3. the last scale's state all to a standard normal.

Each block is an :class:`.icnf.ICNF` (``naugments=0``, non-autonomous, one
Rademacher probe a row held over the solve, no steered end time) with its
own :class:`.nets.ConcatConvNet`, solved over ``[0, 1]`` through
``core._solve`` (:func:`..core.block_terminal`): the unfused route, the
continuous adjoint for ``gradient="adjoint"``.  ``log p(x)`` sums the
logit's log-determinant, each block's change of log-density and the normal
log-densities of the factored-out parts and of the last state; the loss is
``mean(-log p(x) + lambda_1 sum_b E_b + lambda_2 sum_b n_b)`` with the
port's RNODE columns ``dE = |f|``, ``dn = |eps^T df/dz|``.

Parameters are one flat dict, ``blocks.{i}.<the block net's keys>``, so
that the optimizer, checkpoints and the facades (``ICNFModel``,
``ICNFDist``) see one model.  Draws: the blocks' probes, in block order.
There is no exact trace (``Mode.TEST``): a block's state is ``c*h*w``
columns wide; scoring takes Hutchinson probes (``Mode.TRAIN_NOREG``), as
FFJORD evaluates.

Spans ``multiscale.chain`` (a loss or log-density) and ``multiscale.block``
(each block's forward solve; its route ``"<scale>.<block>"``); counters
``multiscale.blocks``, ``multiscale.squeezes``, ``multiscale.factor_outs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import core
from ..config import LOG_2PI, ICNFConfig, Mode, ProbeDist, SolverConfig
from ..ops.ode import SolverStats
from ..utils import profiling
from .icnf import ICNF
from .nets import ConcatConvNet, Params

__all__ = ["MultiscaleICNF", "dequantize", "squeeze", "unsqueeze", "n_scales"]


def n_scales(shape: Sequence[int]) -> int:
    """FFJORD's ``_calc_n_scale``: one scale for each halving of ``(h, w)``
    while both are at least 4 (4 at 32 x 32, 3 at 28 x 28)."""
    _c, h, w = shape
    n = 0
    while h >= 4 and w >= 4:
        n, h, w = n + 1, h // 2, w // 2
    return n


def squeeze(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W) -> (B, 4C, H/2, W/2)``: each 2 x 2 patch to channels
    (FFJORD's ``SqueezeLayer``); volume-preserving."""
    b, c, h, w = x.shape
    return (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
            .reshape(b, 4 * c, h // 2, w // 2))


def unsqueeze(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`squeeze`."""
    b, c, h, w = x.shape
    return (x.reshape(b, c // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
            .reshape(b, c // 4, 2 * h, 2 * w))


def dequantize(generator: torch.Generator, xb: torch.Tensor) -> torch.Tensor:
    """A ``batch_transform`` of 8-bit values (0-255): ``(x + u) / 256`` with
    ``u ~ U[0, 1)`` drawn from ``generator`` (FFJORD's ``add_noise``)."""
    u = torch.rand(xb.shape, generator=generator, dtype=xb.dtype, device=generator.device)
    return (xb + u.to(xb.device)) / 256.0


def _logit(x: torch.Tensor, alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logit(s), sum log((1 - 2 alpha) / (s (1 - s))))`` a row, ``s =
    alpha + (1 - 2 alpha) x`` (FFJORD's ``LogitTransform``)."""
    s = alpha + (1.0 - 2.0 * alpha) * x
    log_s, log_1s = torch.log(s), torch.log(1.0 - s)
    logdet = torch.sum(math.log(1.0 - 2.0 * alpha) - log_s - log_1s, dim=-1)
    return log_s - log_1s, logdet


def _normal_logpdf(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * (z.shape[-1] * LOG_2PI + torch.sum(torch.square(z), dim=-1))


def _add_stats(a: Optional[SolverStats], b: SolverStats) -> SolverStats:
    if a is None:
        return b
    return SolverStats(a.nfe + b.nfe, a.naccept + b.naccept, a.nreject + b.nreject, b.dt_final)


class Step(NamedTuple):
    """One step of the chain: ``kind`` ``"block"``, ``"squeeze"`` or
    ``"factor"`` (keep the first ``shape[0]`` channels); ``scale``;
    ``block`` the block's index (-1 otherwise); ``shape`` the state's ``(c,
    h, w)`` after the step."""

    kind: str
    scale: int
    block: int
    shape: Tuple[int, int, int]


def _block(icnf: ICNF, mode: Mode, z: torch.Tensor, params: Params,
           generator: Optional[torch.Generator], scale: int, index: int,
           tspan: Tuple[torch.Tensor, torch.Tensor]):
    """One block's forward solve: :func:`..core.block_terminal`."""
    profiling.count("multiscale.blocks")
    with profiling.span("multiscale.block", route=f"{scale}.{index}"):
        return core.block_terminal(icnf, mode, z, params, generator, tspan)


@dataclasses.dataclass(frozen=True, eq=False)
class MultiscaleICNF:
    """FFJORD's multiscale chain (see the module's docstring).  ``config``
    describes the whole model to the facades: ``nvariables = c*h*w``, the
    solver, the lambdas; ``blocks`` the ICNFs (each holds its own CUDA
    graphs, :mod:`..ops.adjoint`); ``steps`` the chain's order."""

    config: ICNFConfig
    shape: Tuple[int, int, int]
    alpha: float
    blocks: Tuple[ICNF, ...]
    steps: Tuple[Step, ...]

    @classmethod
    def create(cls, shape: Sequence[int] = (3, 32, 32), nblocks: int = 2,
               hidden: Sequence[int] = (64, 64, 64), alpha: float = 1e-6,
               solver: Optional[SolverConfig] = None, lambda_1: float = 0.01,
               lambda_2: float = 0.01, n_scale: Optional[int] = None,
               dtype=torch.float32) -> "MultiscaleICNF":
        """FFJORD's ``ODENVP`` layout (``n_scale``: at most this many scales,
        FFJORD's ``--n_scale``; None: as many as :func:`n_scales` gives).
        Every block takes ``solver`` (default: ``SolverConfig()``)."""
        solver = solver if solver is not None else SolverConfig()
        if solver.dt0 == "carry":
            raise ValueError('dt0="carry" carries one solve\'s step into the next step\'s; '
                             'a chain has a solve a block: give dt0 as a float or "auto"')
        shape = tuple(int(s) for s in shape)
        scales = n_scales(shape) if n_scale is None else min(int(n_scale), n_scales(shape))
        if scales < 1 or int(nblocks) < 1:
            raise ValueError(f"a chain needs a scale and a block: shape {shape} gives "
                             f"{scales} scales, nblocks={nblocks}")
        blocks: List[ICNF] = []
        steps: List[Step] = []

        def add_blocks(scale: int, shp: Tuple[int, int, int]) -> None:
            for _ in range(int(nblocks)):
                net = ConcatConvNet(shp, hidden, dtype=dtype)
                blocks.append(ICNF.create(
                    nvariables=net.n_out, naugments=0, autonomous=False,
                    probe_dist=ProbeDist.RADEMACHER, steer_rate=0.0, lambda_1=lambda_1,
                    lambda_2=lambda_2, lambda_3=0.0, dtype=dtype, solver=solver, net=net))
                steps.append(Step("block", scale, len(blocks) - 1, shp))

        c, h, w = shape
        for k in range(scales):
            add_blocks(k, (c, h, w))
            if k < scales - 1:
                c, h, w = 4 * c, h // 2, w // 2
                steps.append(Step("squeeze", k, -1, (c, h, w)))
                add_blocks(k, (c, h, w))
                c //= 2
                steps.append(Step("factor", k, -1, (c, h, w)))
        config = ICNFConfig(nvariables=shape[0] * shape[1] * shape[2], naugments=0,
                            probe_dist=ProbeDist.RADEMACHER, steer_rate=0.0, lambda_1=lambda_1,
                            lambda_2=lambda_2, lambda_3=0.0, dtype=dtype, solver=solver)
        return cls(config=config, shape=shape, alpha=float(alpha), blocks=tuple(blocks),
                   steps=tuple(steps))

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Every block's fresh parameters, in block order, from ``generator``
        (on ``device``; default: the card)."""
        return {f"blocks.{i}.{k}": v for i, b in enumerate(self.blocks)
                for k, v in b.init(generator, device).items()}

    @staticmethod
    def block_params(params: Params, index: int) -> Params:
        """Block ``index``'s parameters under its net's own keys."""
        prefix = f"blocks.{index}."
        return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}

    def _flow(self, mode: Mode, xs, params: Params, generator: Optional[torch.Generator]):
        """``(logpx, E, n, latents, stats, single)`` of the rows ``xs``."""
        if mode is Mode.TEST:
            raise ValueError(
                f"MultiscaleICNF has no exact trace: Mode.TEST would sweep each of a block's "
                f"{self.config.nvariables} columns; score with Mode.TRAIN_NOREG (Hutchinson "
                f"probes), as FFJORD evaluates")
        core._need_generator(mode, generator)
        cfg = self.config
        x = torch.as_tensor(xs, dtype=cfg.dtype, device=core._device_of(params))
        x, single = core._as_batch(x)
        if x.ndim != 2 or x.shape[1] != cfg.nvariables:
            raise ValueError(f"rows must be (n, {cfg.nvariables}) (a {self.shape} image "
                             f"flattened), got {tuple(x.shape)}")
        b = x.shape[0]
        # the span's ends made on the device: a float end copied from the host would wait
        # for the stream at every block
        tspan = tuple(torch.full((), t, dtype=cfg.dtype, device=x.device) for t in cfg.tspan)
        y, logp = _logit(x, self.alpha)
        e_sum = n_sum = torch.zeros_like(logp)
        state = y.reshape((b,) + self.shape)
        latents, stats = [], None
        for step in self.steps:
            if step.kind == "block":
                z1, dlogp, e, n, st = _block(self.blocks[step.block], mode, state.reshape(b, -1),
                                             self.block_params(params, step.block), generator,
                                             step.scale, step.block, tspan)
                state = z1.reshape((b,) + step.shape)
                logp, e_sum, n_sum = logp - dlogp, e_sum + e, n_sum + n
                stats = _add_stats(stats, st)
            elif step.kind == "squeeze":
                profiling.count("multiscale.squeezes")
                state = squeeze(state)
            else:
                profiling.count("multiscale.factor_outs")
                out = state[:, step.shape[0]:].reshape(b, -1)
                latents.append(out)
                logp = logp + _normal_logpdf(out)
                state = state[:, :step.shape[0]]
        last = state.reshape(b, -1)
        latents.append(last)
        logp = logp + _normal_logpdf(last)
        return logp, e_sum, n_sum, torch.cat(latents, dim=1), stats, single

    def loss_with_stats(self, mode: Mode, xs, params: Params,
                        generator: Optional[torch.Generator] = None):
        """``(mean(-logpx + lambda_1 E + lambda_2 n), SolverStats summed over
        the blocks)``, the sums of ``E`` and ``n`` over the blocks."""
        with profiling.span("multiscale.chain"):
            logpx, e, n, _z, stats, _single = self._flow(mode, xs, params, generator)
            cfg = self.config
            return torch.mean(-logpx + cfg.lambda_1 * e + cfg.lambda_2 * n), stats

    def log_prob(self, mode: Mode, xs, params: Params,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``log p(x)`` of each row (one ``(c*h*w,)`` row: a scalar), by
        Hutchinson probes (``Mode.TRAIN_NOREG``)."""
        with profiling.span("multiscale.chain"):
            logpx, _e, _n, _z, _stats, single = self._flow(mode, xs, params, generator)
            return logpx[0] if single else logpx

    def latents(self, xs, params: Params) -> torch.Tensor:
        """The concatenated latents of the rows: the factored-out parts in
        order, then the last state, ``(n, c*h*w)``.  The flow map does not
        depend on the probes (drawn here from a generator of seed 0)."""
        g = torch.Generator(device=core._device_of(params)).manual_seed(0)
        with torch.no_grad():
            return self._flow(Mode.TRAIN_NOREG, xs, params, g)[3]
