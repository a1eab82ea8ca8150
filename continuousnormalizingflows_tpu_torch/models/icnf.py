"""The ICNF model object: static config + dynamics network.

Counterpart of ``continuousnormalizingflows_tpu.models.icnf``.  Parameters
live outside the model, in the dict that :meth:`ICNF.init` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ICNFConfig, ProbeDist, SolverConfig, TraceEstimator
from .nets import MLP, DynamicsNet, Params

__all__ = ["ICNF", "default_net"]


def default_net(cfg: ICNFConfig, precision: str = "highest") -> MLP:
    """Reference default dynamics net:
    ``Dense(n_in -> 4*n_in, softplus) -> Dense(softplus) -> Dense(-> n_out)``."""
    h = 4 * cfg.n_in
    return MLP((cfg.n_in, h, h, cfg.n_out), dtype=cfg.dtype, precision=precision)


@dataclasses.dataclass(frozen=True, eq=False)
class ICNF:
    """An infinitesimal continuous normalizing flow: config and net.
    ``graphs``: the CUDA graphs of its fixed-step backsolves on the card, by
    mode (:mod:`..ops.adjoint`), captured on a solve's first call of its
    shapes and held for the flow's life."""

    config: ICNFConfig
    net: DynamicsNet
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def __post_init__(self) -> None:
        if self.net.n_in != self.config.n_in or self.net.n_out != self.config.n_out:
            raise ValueError(
                f"net widths ({self.net.n_in}->{self.net.n_out}) do not match "
                f"config ({self.config.n_in}->{self.config.n_out}); remember the "
                f"net input carries [z({self.config.nz}), t(. if non-autonomous), "
                f"ys({self.config.nconditions})]"
            )

    @classmethod
    def create(
        cls,
        nvariables: int = 1,
        naugments: int = -1,
        nconditions: int = 0,
        autonomous: bool = False,
        tspan=(0.0, 1.0),
        trace: TraceEstimator = TraceEstimator.HUTCH_VJP,
        probe_dist=ProbeDist.GAUSSIAN,
        base_dist=None,
        nprobes: int = 1,
        probe_axis=None,
        exact_chunk: int = 0,
        sweep_axis=None,
        steer_rate: float = 0.1,
        steer_dist=None,
        lambda_1: float = 0.01,
        lambda_2: float = 0.01,
        lambda_3: float = 0.01,
        dtype=None,
        solver: Optional[SolverConfig] = None,
        net: Optional[DynamicsNet] = None,
        precision: str = "highest",
        fused: bool = False,
        fused_adaptive: bool = False,
        layout: str = "batch_first",
    ) -> "ICNF":
        """Build an ICNF with the reference-matching defaults of
        ``continuousnormalizingflows_tpu.ICNF.create``."""
        cfg = ICNFConfig(
            fused=fused,
            fused_adaptive=fused_adaptive,
            layout=layout,
            nvariables=nvariables,
            naugments=naugments,
            nconditions=nconditions,
            autonomous=autonomous,
            tspan=tuple(tspan),
            trace=trace,
            probe_dist=probe_dist,
            base_dist=base_dist,
            nprobes=nprobes,
            probe_axis=probe_axis,
            exact_chunk=exact_chunk,
            sweep_axis=sweep_axis,
            steer_rate=steer_rate,
            steer_dist=steer_dist,
            lambda_1=lambda_1,
            lambda_2=lambda_2,
            lambda_3=lambda_3,
            dtype=dtype if dtype is not None else torch.float32,
            solver=solver if solver is not None else SolverConfig(),
        )
        return cls(config=cfg, net=net if net is not None else default_net(cfg, precision))

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Fresh dynamics-net parameters, drawn from ``generator``, on
        ``device`` (default: the card; ``device="cpu"`` for the CPU)."""
        return self.net.init(generator, device)
