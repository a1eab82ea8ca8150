"""Training front-end: the sklearn/MLJ-style estimator facade.

Counterpart of ``continuousnormalizingflows_tpu.train``: ``ICNFModel`` wraps
an :class:`~continuousnormalizingflows_tpu_torch.models.icnf.ICNF` with an
optimizer and exposes ``fit(X[, Y]) -> FitResult``, ``transform``,
``score``, ``save`` and ``load``.  Defaults as the reference's MLJ facade:
``batchsize = 1024``, ``epochs = 300``, weight decay 1e-4 before Adam(1e-3),
static-shaped shuffled minibatches, the loss logged every 64 steps.

Where the JAX package takes a PRNG key, this takes a ``torch.Generator``.
One generator stream feeds, in order: the parameter init (when no params are
given), each epoch's permutation, and each step's draws (the
``batch_transform``'s, then the probe and the steered end time).  A fit
with ``generator=FitResult.generator``, ``params`` and ``opt_state`` of an
earlier fit continues its stream exactly.

``steps_per_dispatch = k`` runs the steps in blocks of ``k`` and reads the
losses back once per block (one host synchronisation per block instead of
one per logged step).  The steps and their draws are the same for every
``k``, so the trained parameters are the same bits.  The JAX package's
memo of compiled steps has no counterpart (PyTorch runs eagerly), so its
attribute rules reduce to one: ``_conditional`` follows ``icnf``.
``dt0="carry"`` starts each step's adaptive solve (and its backward solve)
from the previous step's final step size, a device tensor: no host
synchronisation.

``mesh=`` (a :func:`.parallel.make_mesh` mesh) trains data-parallel, as
the JAX package's ``ICNFModel(mesh=)``: every rank is given the whole
dataset and the same generator, draws the same permutation, takes its rows
of each minibatch (a ``batch_transform`` draws for the whole minibatch
first) and runs the step of :func:`.parallel.mesh.shard_train_step`: the
loss is the global mean, one gradient all-reduce comes before the same
optimizer step on every rank, and the solvers take one process's steps.
``model`` ranks replicate the step.  ``score`` and validation run sharded
too.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .config import Mode, resolve_device
from .core import _device_of, inference, loss_with_stats
from .dist import _shim_layout
from .models.icnf import ICNF
from .models.multiscale import MultiscaleICNF
from .ops.fused_adaptive import fused_adaptive_applicable, fused_adaptive_tile
from .parallel import mesh as pmesh
from .utils import profiling

__all__ = ["default_optimizer", "ClippedAdam", "FitResult", "ICNFModel", "CondICNFModel"]

Params = Dict[str, torch.Tensor]
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


class ClippedAdam(torch.optim.Adam):
    """Adam with coupled L2 weight decay (the gradient plus ``weight_decay *
    param`` enters the moments: optax's ``add_decayed_weights`` then
    ``adam``, not AdamW), after optional global-norm clipping by optax's
    rule: every gradient is scaled by ``clip_norm / norm`` unless ``norm <
    clip_norm`` (no epsilon).  In a sharded step the gradients are reduced
    already, so every rank clips alike; a tensor-parallel step's norm sums
    the split layers' squares over ``model``
    (:func:`.parallel.mesh.clip_sq_norm`)."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None) -> None:
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_norm is not None:
            pairs = [(p, p.grad) for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
            if pairs:
                norm = torch.sqrt(pmesh.clip_sq_norm(pairs))
                keep = norm < self.clip_norm
                for _p, g in pairs:
                    g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        return super().step(closure)


def default_optimizer(learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                      clip_norm: Optional[float] = None) -> OptimizerFactory:
    """``OptimiserChain(WeightDecay(1e-4), Adam(1e-3))`` equivalent
    (reference core_icnf.jl:17-24), with optional global-norm gradient
    clipping first.  Returns a factory: ``factory(tensors) -> optimizer``."""
    return functools.partial(ClippedAdam, lr=learning_rate, weight_decay=weight_decay,
                             clip_norm=clip_norm)


def _table_to_matrix(X):
    """Tables the way the reference MLJ facade takes them: anything with
    ``to_numpy`` (pandas/polars DataFrames) or a dict of columns becomes an
    ``(n, d)`` matrix; arrays and tensors pass through."""
    if hasattr(X, "to_numpy"):
        return np.asarray(X.to_numpy())
    if isinstance(X, dict):
        return np.stack([np.asarray(col) for col in X.values()], axis=1)
    return X


@dataclasses.dataclass
class FitResult:
    """The reference's ``fitresult`` + ``report``.  ``opt_state`` is the final
    optimizer ``state_dict()`` and ``generator`` the advanced generator: pass
    both back to ``fit(params=..., opt_state=..., generator=...)`` for an
    exact resume.  With ``validation_data``: ``val_history`` is ``[(epoch,
    val_nll), ...]``, ``best_params`` the parameters at the best validation
    NLL (None if no evaluation was finite), ``best_val_nll``/``best_epoch``
    its value and epoch; ``params`` stays the final parameters."""

    params: Params
    history: List[float]
    stats: dict
    opt_state: Any = None
    generator: Optional[torch.Generator] = None
    val_history: List[tuple] = dataclasses.field(default_factory=list)
    best_params: Optional[Params] = None
    best_val_nll: Optional[float] = None
    best_epoch: Optional[int] = None


class ICNFModel:
    """Unconditional density estimator (reference ``ICNFModel``).

    ``optimizer``: a factory ``tensors -> torch.optim.Optimizer`` (default
    :func:`default_optimizer`).  ``generator``: the stream's start, copied at
    each ``fit`` without its own generator (default: seed 0 on ``device``).
    ``device``: where the data, the parameters and the training run
    (default: the card; ``device="cpu"`` trains on the CPU, and without CUDA
    ``fit`` raises unless asked for it; with ``mesh=``, the mesh's device).
    ``params`` given to ``fit`` are copied to it.  ``mesh``: a
    ``torch.distributed`` ``DeviceMesh`` from :func:`.parallel.make_mesh`
    (see the module's docstring)."""

    def __init__(
        self,
        icnf: ICNF,
        optimizer: Optional[OptimizerFactory] = None,
        batchsize: int = 1024,
        epochs: int = 300,
        generator: Optional[torch.Generator] = None,
        log_every: int = 64,
        callback: Optional[Callable[[int, float], None]] = None,
        val_callback: Optional[Callable[[int, float], None]] = None,
        mesh=None,
        steps_per_dispatch: int = 1,
        batch_transform: Optional[Callable[[torch.Generator, torch.Tensor],
                                           torch.Tensor]] = None,
        eval_icnf: Optional[ICNF] = None,
        device=None,
    ) -> None:
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a DeviceMesh (parallel.make_mesh), got "
                            f"{type(mesh).__name__}")
        if mesh is not None and isinstance(icnf, MultiscaleICNF):
            raise ValueError("a MultiscaleICNF trains on one device: mesh= (data "
                             "parallelism) is not implemented for a chain of flows")
        if int(steps_per_dispatch) < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if eval_icnf is not None and (
            eval_icnf.config.nvariables != icnf.config.nvariables
            or eval_icnf.config.nconditions != icnf.config.nconditions
        ):
            raise ValueError(
                "eval_icnf must match the training icnf's nvariables/nconditions "
                "(it evaluates the same params)"
            )
        self.icnf = icnf
        self.optimizer = optimizer if optimizer is not None else default_optimizer()
        self.batchsize = int(batchsize)
        self.epochs = int(epochs)
        self.generator = generator
        self.log_every = log_every
        self.callback = callback
        # called as val_callback(epoch, val_nll) after each validation
        self.val_callback = val_callback
        self.steps_per_dispatch = int(steps_per_dispatch)
        # per-step data augmentation: xb = batch_transform(generator, xb)
        self.batch_transform = batch_transform
        # TestMode model for score()/validation; None evaluates with icnf
        self.eval_icnf = eval_icnf
        self.mesh = mesh
        self._device = None if device is None else torch.device(device)

    @property
    def device(self) -> torch.device:
        """Where ``fit`` runs (raises without CUDA unless given the CPU; the
        mesh's device with a mesh)."""
        if self.mesh is not None:
            return pmesh.mesh_device(self.mesh)
        return resolve_device(self._device)

    @property
    def _conditional(self) -> bool:
        return self.icnf.config.conditioned

    # -- internals ---------------------------------------------------------

    def _start_generator(self, device) -> torch.Generator:
        """A copy of the constructor's generator (seed 0 on ``device`` by
        default): every fit without ``generator=`` starts the same stream."""
        if self.generator is None:
            return torch.Generator(device=device).manual_seed(0)
        g = torch.Generator(device=self.generator.device)
        g.set_state(self.generator.get_state())
        return g

    def _batches(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """``(n // batchsize, batchsize)`` row indices of a fresh permutation
        (static-shaped: the remainder rotates in through the next epochs'
        permutations); the whole dataset as one batch when ``batchsize <= 0``
        or ``>= n``."""
        bs = self.batchsize
        if bs <= 0 or bs >= n:
            return torch.arange(n)[None, :]
        perm = torch.randperm(n, generator=generator, device=generator.device)
        nb = n // bs
        return perm[: nb * bs].reshape(nb, bs)

    def _split_rows(self) -> bool:
        return self.mesh is not None and self.mesh.size(0) > 1

    def _carry_dt(self, batch: int) -> bool:
        """``dt0="carry"``: warm-start each step's embedded-RK solve from the
        previous step's accepted step size.  Inert, so off, where the
        adaptive whole-solve kernels take the step: their controllers keep
        the fixed start (the JAX package passes the carry there unused).
        ``batch``: a rank's rows."""
        cfg = self.icnf.config
        s = cfg.solver
        return (s.dt0 == "carry" and s.method in ("dopri5", "tsit5")
                and not (fused_adaptive_applicable(cfg, self.icnf.net, Mode.TRAIN)
                         and fused_adaptive_tile(batch, whole_groups=self._split_rows())))

    def _loss_step(self, params: Params, generator: torch.Generator, xb: torch.Tensor,
                   yb: Optional[torch.Tensor], dt0: Optional[torch.Tensor] = None):
        """The train step's loss on a minibatch (a rank's rows of it):
        ``(loss, solver stats)``.  ``dt0``: the carried start, or None.  A
        chain of flows sums its blocks' solves (its stats too)."""
        if isinstance(self.icnf, MultiscaleICNF):
            return self.icnf.loss_with_stats(Mode.TRAIN, xb, params, generator)
        return loss_with_stats(self.icnf, Mode.TRAIN, xb, params, generator, ys=yb, dt0=dt0)

    def _make_step(self, carry: bool) -> Callable:
        """``step(params, opt, generator, xb, yb[, dt0]) -> (loss, stats)``:
        one optimizer step on a minibatch (this rank's rows of it with a
        mesh), the loss left on the device."""
        if self.mesh is not None:
            return pmesh.shard_train_step(self._loss_step, self.mesh, self._conditional,
                                          n_extra_repl=1 if carry else 0)

        def step(params, opt, generator, xb, yb, *extra):
            opt.zero_grad(set_to_none=True)
            l, stats = self._loss_step(params, generator, xb, yb, *extra)
            l.backward()
            with profiling.span("optimizer.step"):
                opt.step()
            return l.detach(), stats

        return step

    def _minibatch(self, generator: torch.Generator, xs_all, ys_all, idx):
        """The rows ``idx`` (a ``batch_transform`` drawn for all of them),
        cut to this rank's with a mesh."""
        xb = xs_all[idx]
        yb = None if ys_all is None else ys_all[idx]
        if self.batch_transform is not None:
            xb = self.batch_transform(generator, xb)
        if self.mesh is not None:
            xb, yb = pmesh.shard_batch_arrays(self.mesh, xb, yb)
        return xb, yb

    # -- public API --------------------------------------------------------

    def fit(
        self,
        X,
        Y=None,
        params: Optional[Params] = None,
        opt_state: Any = None,
        generator: Optional[torch.Generator] = None,
        validation_data=None,
        eval_every: int = 1,
        patience: Optional[int] = None,
    ) -> FitResult:
        """Run the epochs x minibatch maximum-likelihood loop (reference fit,
        core_icnf.jl:32-58).  ``X``: ``(n, nvariables)``; ``Y``: ``(n,
        nconditions)`` for conditional models.  ``params`` (copied, never
        modified), ``opt_state`` and ``generator`` warm-start it.

        ``validation_data``: held-out ``Xval`` (or ``(Xval, Yval)``); every
        ``eval_every`` epochs its mean TestMode NLL (:meth:`score`) is taken
        and the best parameters kept.  ``patience``: stop after this many
        evaluations in a row without improvement (a non-finite NLL counts as
        none).  Validation draws nothing from the generator, so a validated
        run trains the same bits as an unvalidated one up to its stop."""
        with profiling.span("fit.call"):
            icnf = self.icnf
            cfg = icnf.config
            device = self.device
            xs_all = torch.as_tensor(_table_to_matrix(X), dtype=cfg.dtype, device=device)
            if xs_all.ndim != 2 or xs_all.shape[1] != cfg.nvariables:
                raise ValueError(f"X must be (n, {cfg.nvariables}), got {tuple(xs_all.shape)}")
            ys_all = None
            if self._conditional:
                if Y is None:
                    raise ValueError("conditional model requires Y")
                ys_all = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
                if ys_all.shape != (xs_all.shape[0], cfg.nconditions):
                    raise ValueError(
                        f"Y must be (n, {cfg.nconditions}), got {tuple(ys_all.shape)}")
            n = xs_all.shape[0]

            val_active = validation_data is not None
            xval = yval = None
            if val_active:
                if int(eval_every) < 1:
                    raise ValueError(f"eval_every must be >= 1, got {eval_every}")
                if isinstance(validation_data, (tuple, list)):
                    xval, yval = validation_data
                else:
                    xval = validation_data
                if self._conditional and yval is None:
                    raise ValueError("conditional model requires validation_data=(Xval, Yval)")
            val_history: List[tuple] = []
            best_params: Optional[Params] = None
            best_val = float("inf")
            best_epoch: Optional[int] = None
            stale = 0

            def epoch_end(epoch_done: int, params: Params) -> bool:
                """Validation at an epoch boundary; True = stop early."""
                nonlocal best_params, best_val, best_epoch, stale
                if not val_active:
                    return False
                if epoch_done % eval_every != 0 and epoch_done != self.epochs:
                    return False
                vnll = self.score(xval, params, Y=yval)
                val_history.append((epoch_done, vnll))
                if self.val_callback is not None:
                    self.val_callback(epoch_done, vnll)
                if vnll < best_val:  # NaN compares False: counts as stale below
                    best_val, best_epoch, stale = vnll, epoch_done, 0
                    best_params = {k: v.detach().clone() for k, v in params.items()}
                    return False
                stale += 1
                return patience is not None and stale >= patience

            gen = generator if generator is not None else self._start_generator(device)
            if params is None:
                params = icnf.init(gen, device)
            else:
                params = {k: v.detach().to(device).clone() for k, v in params.items()}
            params = {k: v.requires_grad_() for k, v in params.items()}
            opt = self.optimizer(list(params.values()))
            if opt_state is not None:
                opt.load_state_dict(opt_state)

            history: List[float] = []
            it = 0
            epochs_run = 0
            t_start = time.perf_counter()
            last_loss = float("nan")
            sol_stats = None
            spd = self.steps_per_dispatch
            rows = n if self.batchsize <= 0 or self.batchsize >= n else self.batchsize
            if self.mesh is not None and rows % self.mesh.size(0):
                raise ValueError(f"minibatches of {rows} rows do not split evenly over the "
                                 f"{self.mesh.size(0)} ranks of the mesh's data axis")
            carry = self._carry_dt(rows // (self.mesh.size(0) if self.mesh is not None else 1))
            step = self._make_step(carry)
            # the carried start: 0 makes the first solve take the fixed-fraction
            # start (the override's fallback); each later one the previous |dt|
            tdt = cfg.dtype if cfg.dtype.is_floating_point else torch.float32
            dt_prev = torch.zeros((), dtype=tdt, device=device)
            for epoch in range(self.epochs):
                batches = self._batches(gen, n)
                for blk in range(0, batches.shape[0], spd):
                    losses = []
                    for idx in batches[blk: blk + spd]:
                        with profiling.span("fit.step"):
                            xb, yb = self._minibatch(gen, xs_all, ys_all, idx)
                            l, sol_stats = step(params, opt, gen, xb, yb,
                                                *((dt_prev,) if carry else ()))
                            if carry:
                                dt_prev = torch.abs(sol_stats.dt_final).detach()
                        losses.append(l)
                    logged = [j for j in range(len(losses)) if (it + j) % self.log_every == 0]
                    if logged:
                        stacked = torch.stack(losses)
                        with profiling.host_read("fit.read"):  # one synchronisation per block
                            values = stacked.tolist()
                        for j in logged:
                            last_loss = values[j]
                            history.append(last_loss)
                            if self.callback is not None:
                                self.callback(it + j, last_loss)
                    it += len(losses)
                epochs_run = epoch + 1
                if epoch_end(epochs_run, params):
                    break
            if it:
                with profiling.host_read("fit.read"):
                    last_loss = float(l)
            stats = {
                "iterations": it,
                "epochs": self.epochs,
                "epochs_run": epochs_run,
                "wall_time_s": time.perf_counter() - t_start,
                "final_loss": last_loss,
            }
            if val_active:
                stats.update(
                    best_val_nll=best_val if best_epoch is not None else float("nan"),
                    best_epoch=best_epoch,
                    stopped_early=epochs_run < self.epochs,
                    val_evals=len(val_history),
                )
            if sol_stats is not None:
                # per-solve diagnostics of the last step
                with profiling.host_read("fit.read"):
                    stats.update(nfe=int(sol_stats.nfe), naccept=int(sol_stats.naccept),
                                 nreject=int(sol_stats.nreject),
                                 dt_final=float(sol_stats.dt_final))
            return FitResult(
                params={k: v.detach() for k, v in params.items()}, history=history, stats=stats,
                opt_state=opt.state_dict(), generator=gen, val_history=val_history,
                best_params=best_params,
                best_val_nll=(best_val if best_epoch is not None else None),
                best_epoch=best_epoch,
            )

    def transform(self, X, params: Params, Y=None) -> torch.Tensor:
        """TestMode densities ``exp(logpx)`` (reference transform,
        core_icnf.jl:60-68) of a table, an ``(n, d)`` matrix, one ``(d,)``
        sample, or a features-first ``(d, n)`` matrix (transposed with a
        warning).  A :class:`MultiscaleICNF` (no exact trace) gives its
        concatenated latents ``(n, d)`` instead."""
        cfg = self.icnf.config
        xs = torch.as_tensor(_table_to_matrix(X), dtype=cfg.dtype, device=_device_of(params))
        if xs.ndim == 2:
            xs = _shim_layout(xs, cfg.nvariables)
        if isinstance(self.icnf, MultiscaleICNF):
            return self.icnf.latents(xs, params)
        with torch.no_grad():
            logpx = inference(self.icnf, Mode.TEST, xs, params,
                              ys=Y if self._conditional else None)[0]
        return torch.exp(logpx)

    def score(self, X, params: Params, Y=None) -> float:
        """Mean negative log-likelihood (nats) under the deterministic
        TestMode exact trace, with ``eval_icnf`` when set.  A
        :class:`MultiscaleICNF` (no exact trace) is scored by Hutchinson
        probes (``Mode.TRAIN_NOREG``) drawn from the start of the model's
        generator stream, as FFJORD evaluates."""
        icnf_eval = self.eval_icnf if self.eval_icnf is not None else self.icnf
        if self._conditional and Y is None:
            raise ValueError("conditional model requires Y to score")
        cfg = icnf_eval.config
        xs = torch.as_tensor(_table_to_matrix(X), dtype=cfg.dtype, device=_device_of(params))
        if isinstance(icnf_eval, MultiscaleICNF):
            with torch.no_grad():
                logpx = icnf_eval.log_prob(Mode.TRAIN_NOREG, xs, params,
                                           self._start_generator(xs.device))
            return -float(torch.mean(logpx))
        ys = Y if self._conditional else None
        if self.mesh is not None and xs.ndim == 2 and xs.shape[0] % self.mesh.size(0) == 0:
            # sharded: each rank its rows, the mean over every rank's
            if ys is not None:
                ys = torch.as_tensor(ys, dtype=cfg.dtype, device=xs.device)
            xs, ys = pmesh.shard_batch_arrays(self.mesh, xs, ys)
            with torch.no_grad(), pmesh.use_mesh(self.mesh):
                logpx = inference(icnf_eval, Mode.TEST, xs, params, ys=ys)[0]
                return -float(pmesh.global_mean(torch.sum(logpx), logpx.numel()))
        with torch.no_grad():
            logpx = inference(icnf_eval, Mode.TEST, xs, params, ys=ys)[0]
        return -float(torch.mean(logpx))

    # -- persistence (reference MLJBase.save / machine(file)) ---------------

    def save(self, path: str, result: FitResult) -> None:
        """Params, optimizer state and step count of ``result`` to ``path``."""
        from .utils.checkpoint import save_checkpoint

        save_checkpoint(path, result.params, result.opt_state,
                        step=result.stats.get("iterations", 0))

    def load(self, path: str, map_location=None) -> Params:
        from .utils.checkpoint import load_checkpoint

        params, _opt, _step = load_checkpoint(path, map_location)
        return params


class CondICNFModel(ICNFModel):
    """Conditional variant (reference ``CondICNFModel``): the same loop on
    ``(X, Y)`` data."""

    def __init__(self, icnf: ICNF, **kwargs) -> None:
        if not icnf.config.conditioned:
            raise ValueError("CondICNFModel requires nconditions > 0")
        super().__init__(icnf, **kwargs)
