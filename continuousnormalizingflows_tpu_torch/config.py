"""Static configuration of an ICNF, in PyTorch.

Counterpart of ``continuousnormalizingflows_tpu.config``: the same frozen
dataclasses, the same validation and the same derived sizes, with
``torch.float32`` as the default dtype.  Variant mapping (FFJORD, RNODE,
ANODE, STEER, conditional, non-autonomous) is as in the JAX package.

``probe_axis``/``sweep_axis`` name the mesh axis that splits
the probe ensemble or the exact sweep inside a sharded step
(:mod:`.parallel.mesh`); JAX validates neither, nor does the port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import torch

# log(2*pi), shared by the normal log-densities in core and utils.datasets
LOG_2PI = 1.8378770664093453

# The fixed-fraction starting step of the adaptive solvers: the start of the
# whole-solve kernels, of every backward adjoint solve under dt0="auto", and
# the fallback of a non-finite carried start.
DEFAULT_FIXED_DT0 = 0.01

# Hard cap on the multistep history ring (validation parity with JAX).
ABM_MAX_ORDER = 12

__all__ = [
    "LOG_2PI",
    "DEFAULT_FIXED_DT0",
    "Mode",
    "TraceEstimator",
    "ProbeDist",
    "SolverConfig",
    "ICNFConfig",
    "resolve_device",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, the card when
    it is None.  The port runs on the card unless asked for the CPU
    (``device="cpu"``); without CUDA, a call that asks for the card raises,
    and never carries on on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card unless asked for the '
                           'CPU; pass device="cpu" to run there')
    return device


class Mode(enum.Enum):
    """``TEST``: exact trace, no regularization.  ``TRAIN``: Hutchinson trace
    with the RNODE accumulators integrated.  ``TRAIN_NOREG``: Hutchinson trace,
    accumulators forced to zero."""

    TEST = "test"
    TRAIN = "train"
    TRAIN_NOREG = "train_noreg"

    @property
    def stochastic(self) -> bool:
        return self is not Mode.TEST

    @property
    def regularized(self) -> bool:
        return self is Mode.TRAIN


class TraceEstimator(str, enum.Enum):
    HUTCH_VJP = "hutch_vjp"  # eps^T J by reverse mode (default)
    HUTCH_JVP = "hutch_jvp"  # J eps by forward mode
    EXACT = "exact"  # full Jacobian diagonal, forced in Mode.TEST


class ProbeDist(str, enum.Enum):
    GAUSSIAN = "gaussian"
    RADEMACHER = "rademacher"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """ODE solve and gradient configuration (fields as in the JAX package).

    The default is the JAX package's stack: dopri5 at rtol = atol = 1e-4
    with the HNW starting step and the backsolve adjoint.  ``rk4``/``euler``
    (``backprop`` or ``adjoint``), ``dopri5``/``tsit5``/``abm`` (``adjoint``
    or ``quadrature``; ``abm`` with ``quadrature`` is the reference's VCABM
    with ``QuadratureAdjoint``) and ``dt0`` as a float, ``"auto"`` or
    ``"carry"`` (``abm`` takes the fixed-fraction start for both) run."""

    method: str = "dopri5"
    rtol: float = 1.0e-4
    atol: float = 1.0e-4
    max_steps: int = 16_384
    fixed_steps: int = 64
    gradient: str = "adjoint"
    remat: bool = True  # per-step recompute in the backward (torch.utils.checkpoint)
    dt0: Any = "auto"
    dense_max_nodes: int = 128
    adjoint_seminorm: bool = True
    safety: float = 0.9
    max_factor: float = 10.0
    min_factor: float = 0.2
    abm_order: int = 4

    def __post_init__(self) -> None:
        adaptive = ("dopri5", "tsit5", "abm")
        if self.method not in adaptive + ("rk4", "euler"):
            raise ValueError(f"unknown ODE method {self.method!r}")
        if not 1 <= self.abm_order <= ABM_MAX_ORDER:
            raise ValueError(
                f"abm_order must be in [1, {ABM_MAX_ORDER}], got {self.abm_order}"
            )
        if self.gradient not in ("adjoint", "quadrature", "backprop"):
            raise ValueError(f"unknown gradient mode {self.gradient!r}")
        if isinstance(self.dt0, str):
            if self.dt0 not in ("auto", "carry"):
                raise ValueError(
                    f'dt0 must be a float, "auto", or "carry", got {self.dt0!r}'
                )
        elif not float(self.dt0) > 0.0:
            raise ValueError(f"dt0 must be positive, got {self.dt0!r}")
        if self.gradient == "backprop" and self.method in adaptive:
            raise ValueError(
                "backprop gradients require a fixed-step method (rk4/euler); "
                "use gradient='adjoint' with an adaptive method"
            )
        if self.gradient == "quadrature" and self.method not in adaptive:
            raise ValueError(
                "the interpolation (quadrature) adjoint needs an adaptive "
                "dense-output solver (dopri5/tsit5/abm); fixed-step methods "
                "support gradient='backprop'"
            )


@dataclasses.dataclass(frozen=True)
class ICNFConfig:
    """Hyperparameters of one ICNF, with the reference's defaults:
    augmentation on (``naugments = nvariables + 1``), non-autonomous,
    ``tspan = (0, 1)``, ``lambda_1 = lambda_2 = lambda_3 = 0.01``,
    ``steer_rate = 0.1``, float32, standard-normal base and probe."""

    nvariables: int = 1
    naugments: int = -1  # -1 => nvariables + 1
    nconditions: int = 0
    autonomous: bool = False
    tspan: Tuple[float, float] = (0.0, 1.0)
    trace: TraceEstimator = TraceEstimator.HUTCH_VJP
    probe_dist: Any = ProbeDist.GAUSSIAN
    base_dist: Any = None
    nprobes: int = 1
    probe_axis: Any = None
    exact_chunk: int = 0
    sweep_axis: Any = None
    steer_rate: float = 0.1
    steer_dist: Any = None
    lambda_1: float = 0.01
    lambda_2: float = 0.01
    lambda_3: float = 0.01
    dtype: Any = torch.float32
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    # Route Hutchinson-VJP solves of a 3-layer softplus MLP through the hand
    # written CUDA kernels (whole-solve RK4, or the per-stage fused dynamics);
    # with fused_adaptive too, regularized dopri5 train solves take the
    # adaptive whole-solve kernels (per-group step control: other answers
    # than the global-norm solve, so opt-in, as in the JAX package).
    fused: bool = False
    fused_adaptive: bool = False
    # The array layout inside a solve: "batch_first" (batch, features), or
    # "feature_first" (features, batch), as in the JAX package.  The public
    # API stays batch-first: one transpose in and one out a solve.  A
    # feature-first solve takes no fused route (core._solve).
    layout: str = "batch_first"

    def __post_init__(self) -> None:
        if self.naugments < 0:
            object.__setattr__(self, "naugments", self.nvariables + 1)
        if self.nvariables < 1:
            raise ValueError("nvariables must be >= 1")
        if not isinstance(self.trace, TraceEstimator):
            object.__setattr__(self, "trace", TraceEstimator(self.trace))
        if not isinstance(self.probe_dist, ProbeDist):
            if getattr(self.probe_dist, "sample_fn", None) is not None:
                pass  # custom probe: duck-typed
            elif hasattr(self.probe_dist, "sample_fn") or not isinstance(
                self.probe_dist, str
            ):
                raise ValueError(
                    "probe_dist must be a ProbeDist enum value or a "
                    "distribution with a non-None sample_fn(key, shape, dtype) "
                    f"(see distributions.CustomDist); got {self.probe_dist!r} "
                    "with sample_fn=None"
                )
            else:
                object.__setattr__(self, "probe_dist", ProbeDist(self.probe_dist))
        if self.steer_dist is not None and (
            getattr(self.steer_dist, "sample_fn", None) is None
        ):
            raise ValueError(
                "steer_dist needs a non-None sample_fn(key, shape, dtype) "
                "(see distributions.CustomDist); None selects "
                "Uniform(-steer_rate, steer_rate)"
            )
        if self.base_dist is not None and (
            getattr(self.base_dist, "logpdf_fn", None) is None
            or getattr(self.base_dist, "sample_fn", None) is None
        ):
            raise ValueError(
                "base_dist needs both logpdf_fn and sample_fn (see "
                "distributions.CustomDist); None selects the standard normal"
            )
        if self.layout not in ("batch_first", "feature_first"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.exact_chunk < 0:
            raise ValueError(
                f"exact_chunk must be >= 0 (0 = unchunked), got {self.exact_chunk}"
            )
        object.__setattr__(self, "tspan", (float(self.tspan[0]), float(self.tspan[1])))

    # ---- derived sizes ----

    @property
    def augmented(self) -> bool:
        return self.naugments != 0

    @property
    def conditioned(self) -> bool:
        return self.nconditions != 0

    @property
    def steered(self) -> bool:
        return self.steer_rate != 0.0 or self.steer_dist is not None

    @property
    def nz(self) -> int:
        """Flow-state dimension = nvariables + naugments."""
        return self.nvariables + self.naugments

    @property
    def n_aug_input(self) -> int:
        return self.naugments if self.augmented else 0

    @property
    def state_dim(self) -> int:
        """Augmented ODE state width: ``[z, dlogp, E, n]``."""
        return self.nz + 3

    @property
    def n_in(self) -> int:
        return self.nz + (0 if self.autonomous else 1) + self.nconditions

    @property
    def n_out(self) -> int:
        return self.nz

    @property
    def norm_z(self) -> bool:
        return self.lambda_1 != 0.0

    @property
    def norm_j(self) -> bool:
        return self.lambda_2 != 0.0

    @property
    def norm_z_aug(self) -> bool:
        return self.lambda_3 != 0.0

    def trace_for(self, mode: Mode) -> TraceEstimator:
        """TEST mode always uses the exact trace."""
        return TraceEstimator.EXACT if mode is Mode.TEST else self.trace
