"""Continuous normalizing flows in PyTorch, with hand-written CUDA kernels for
an NVIDIA H100.

The port of ``continuousnormalizingflows_tpu`` (JAX/Pallas on a TPU), which
stays beside it as the reference.  Ported so far: the log-density and
sampling path (config, the ICNF model,
``inference``/``log_prob``/``loss``/``generate``/``trajectory``,
``ICNFDist``/``CondICNFDist``), training (``ICNFModel``,
``CondICNFModel``, ``default_optimizer``, checkpoints), and the solvers:
fixed-step rk4/euler with backprop, the reference-default adaptive dopri5
(and tsit5) with the HNW start, the carried start and dense output, and
the adaptive-order multistep ``abm`` (Adams-Bashforth-Moulton), the
backsolve and quadrature adjoints; every trace estimator (the exact sweep,
the planar and MLP analytic traces, Hutchinson by VJP or JVP); the nets
``MLP``, ``Planar``, ``CondLayer`` and ``from_torch``; FFJORD's multiscale
image flow (``MultiscaleICNF``: a chain of blocks with ``ConcatConvNet``
dynamics, squeezes and factor-outs; the port's own); custom base,
probe and steer distributions (``distributions``); and ``utils``: the
datasets, ``AsyncCheckpointer``, ``profiling.trace``/``StepTimer`` and the
serving export (``export_logpdf``/``export_sampler`` on ``torch.export``,
whose adaptive solves run as one device loop).  Six CUDA kernels carry the
stochastic modes: the fused dynamics stage and its backward
(``ops.fused_dynamics``), the whole RK4 solve and its backward
(``ops.fused_solve``), and the whole adaptive dopri5 solve and its backward
(``ops.fused_adaptive``, opt-in with ``fused_adaptive=True``).

The entry points run on the card unless asked for the CPU: ``init`` and
``ICNFModel`` take ``device="cpu"`` for that (without CUDA they raise
otherwise), and ``ICNFDist``, ``inference``, ``generate`` and the rest run
where their params are.  Quick start::

    import torch
    import continuousnormalizingflows_tpu_torch as cnf

    icnf = cnf.ICNF.create(nvariables=2)  # dopri5, rtol = atol = 1e-4, adjoint
    params = icnf.init(torch.Generator().manual_seed(0))  # on the card
    d = cnf.ICNFDist(icnf, params, cnf.Mode.TRAIN)
    lp = d.logpdf(x)
    fit = cnf.ICNFModel(icnf, batchsize=65_536, epochs=8).fit(x)
"""

from . import distributions, utils
from .config import ICNFConfig, Mode, ProbeDist, SolverConfig, TraceEstimator
from .core import (base_logpdf, generate, generate_with_logp, inference, log_prob, loss,
                   loss_with_stats, trajectory)
from .dist import CondICNFDist, ICNFDist
from .distributions import CustomDist
from .models.icnf import ICNF, default_net
from .models.multiscale import MultiscaleICNF, dequantize
from .models.nets import MLP, ConcatConvNet, CondLayer, DynamicsNet, Planar, from_torch, planar_h
from .train import CondICNFModel, FitResult, ICNFModel, default_optimizer

__version__ = "0.1.0"

__all__ = [
    "ICNF",
    "MultiscaleICNF",
    "dequantize",
    "ICNFConfig",
    "Mode",
    "ProbeDist",
    "CustomDist",
    "distributions",
    "utils",
    "SolverConfig",
    "TraceEstimator",
    "MLP",
    "Planar",
    "ConcatConvNet",
    "CondLayer",
    "DynamicsNet",
    "default_net",
    "from_torch",
    "planar_h",
    "inference",
    "loss_with_stats",
    "generate",
    "generate_with_logp",
    "loss",
    "log_prob",
    "trajectory",
    "base_logpdf",
    "ICNFDist",
    "CondICNFDist",
    "default_optimizer",
    "FitResult",
    "ICNFModel",
    "CondICNFModel",
    "__version__",
]
