"""The multiscale image cell: ``ICNFModel.fit`` of the port's
``MultiscaleICNF`` (FFJORD's multiscale chain of conv blocks) on a pool of
8-bit images, dequantised a minibatch by the port's ``dequantize``
``batch_transform``.

Each fit call takes the next ``rows`` of the pool in an order drawn from the
seed (an epoch of the pool in chunks) and runs one epoch over them: its own
permutation, ``rows // batch`` minibatches, the optimizer's steps chained
inside the call.  The window is ``"continued"``: each call passes its
``params``, ``opt_state`` and ``generator`` on to the next.

The check is :mod:`.fit`'s (set-up's call from the benchmark's weights, and
one of the window's first calls drawn from the seed, each over its first
``check_steps`` steps; loss, first gradient and change, worst leaf first;
the loss gap over the larger of the loss and the image's dimension)
against :mod:`port_bench.reference.multiscale`: the reference redraws the
call's permutation, each step's dequantisation noise and the blocks'
probes from the kept generator state, gathers the same rows and follows
the steps through its written-out backsolve adjoint and Adam.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import torch

from .. import data, images, multiscale_readers
from ..reference import cnf as ref_cnf
from ..reference import multiscale as ref
from . import fit


class CallStart(NamedTuple):
    """Where a checked call starts: :class:`.fit.Start`'s weights, Adam state
    and generator state, and the call's rows."""

    weights: List[torch.Tensor]
    adam: Optional[dict]
    gen_state: torch.Tensor
    x: torch.Tensor


def channels_of(config: dict) -> list:
    """Each block's widths ``(c, hidden..., c)``, in chain order."""
    return [(s[0],) + tuple(config["hidden"]) + (s[0],)
            for s in ref.block_shapes(config["shape"], config["nblocks"])]


def build_chain(config: dict, cell: dict):
    """The port's chain of a configuration and a cell's solver stack."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import SolverConfig

    chain = cnf.MultiscaleICNF.create(
        shape=config["shape"], nblocks=config["nblocks"], hidden=config["hidden"],
        alpha=config["alpha"], solver=SolverConfig(**cell["solver"]),
        lambda_1=config["lambda_1"], lambda_2=config["lambda_2"])
    shapes = [tuple(b.net.shape) for b in chain.blocks]
    n_params = sum(p.numel() for b in chain.blocks for p in b.net.parameters())
    if shapes != ref.block_shapes(config["shape"], config["nblocks"]) \
            or n_params != config["parameters"]:
        raise ValueError(f"the port's chain has blocks {shapes} and {n_params} parameters, "
                         f"the configuration states {config['blocks']} blocks and "
                         f"{config['parameters']}")
    return chain


class Driver(fit.Driver):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self.pool_rows = int(self.cell["pool"])
        self.calls = 0

    def _data(self) -> None:
        ctx, c = self.ctx, self.config
        self.pool = images.synthetic_images(ctx.seed, self.pool_rows, c["shape"], ctx.device)
        self.order = torch.randperm(self.pool_rows, device=ctx.device,
                                    generator=data.generator(ctx.seed, "order", ctx.device))
        self.dims = [s[0] * s[1] * s[2] for s in ref.block_shapes(c["shape"], c["nblocks"])]
        self.w0 = images.conv_weights(ctx.seed, channels_of(c), ctx.device)
        self.train_x = self._call_rows()
        self.setup_start = CallStart(self.w0, None,
                                     data.generator(ctx.seed, "train", ctx.device).get_state(),
                                     self.train_x)

    def _call_rows(self) -> torch.Tensor:
        """The next call's rows: the next chunk of the pool's order."""
        k = self.calls % (self.pool_rows // self.rows)
        self.calls += 1
        return self.pool[self.order[k * self.rows:(k + 1) * self.rows]]

    def setup(self) -> None:
        import continuousnormalizingflows_tpu_torch as cnf

        ctx = self.ctx
        chain = build_chain(self.config, self.cell)
        self.phases = {"imported_s": time.perf_counter() - ctx.t_start}
        self._data()
        self.phases["data_s"] = time.perf_counter() - ctx.t_start
        opt = self.cell["optimizer"]
        self.model = cnf.ICNFModel(
            chain, optimizer=cnf.default_optimizer(opt["lr"], opt["weight_decay"]),
            batchsize=self.batch, epochs=1, log_every=fit.LOG_EVERY,
            steps_per_dispatch=self.rows // self.batch, batch_transform=cnf.dequantize,
            device=ctx.device)
        gen = data.generator(ctx.seed, "train", ctx.device)
        params = images.as_chain_params(self.w0, len(self.config["hidden"]) + 1)
        res, self.setup_got = self._fit(params, None, gen, record=True)
        self.phases["call_s"] = time.perf_counter() - ctx.t_start
        self.state = (res.params, res.opt_state, res.generator)
        self.start = None

    def setup_reference_only(self) -> None:
        raise NotImplementedError("the multiscale cell runs on one chip")

    def unit(self) -> dict:
        params, opt_state, gen = self.state
        self.train_x = self._call_rows()
        record = self.in_window and self.units <= self.check_unit
        if record:
            start = CallStart([v.detach() for v in params.values()], fit.adam_state(opt_state),
                              gen.get_state(), self.train_x)
        with self._adjoint_ranges():
            res, got = self._fit(params, opt_state, gen, record)
        if record:
            self.window_got = dict(got, start=start, unit=self.units)
        self.units += 1
        self.state = (res.params, res.opt_state, res.generator)
        steps = int(res.stats["iterations"])
        finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                         res.history + [res.stats["final_loss"]]))
        return {"steps": steps, "rows": steps * self.batch, "bad": 0 if finite else steps}

    def _adjoint_ranges(self):
        """In the traced section (the calls after the window of a traced
        run), the adjoint's backward solves timed on the device for
        ``adjoint_share.train_multiscale``."""
        if not self.ctx.trace or self.in_window:
            return contextlib.nullcontext()
        from continuousnormalizingflows_tpu_torch.ops import adjoint

        return multiscale_readers.ADJOINT.around(adjoint, "_backward_solve")

    def free(self) -> None:
        super().free()
        self.pool = self.order = None

    # ---- the check ----

    def follow(self, start: CallStart, prec: str, rows: int = 0, steps: int = 0) -> dict:
        """The plain reference over the first ``steps`` (default: the check's)
        steps of the call from ``start``: each step's loss, the first step's
        gradient, the weights and Adam state at the end.  ``rows``: the loss
        over the first ``rows`` of each minibatch only (a planted fault),
        0 for all of them."""
        c, cell, dev = self.config, self.cell, self.ctx.device
        b = self.batch
        steps = steps or self.check_steps
        used = rows or b
        opt = cell["optimizer"]
        idx, draws, _ = ref.fit_call_draws(start.gen_state, dev, self.rows, b, steps, self.dims)
        w = [t.detach().clone() for t in start.weights]
        state = None if start.adam is None else dict(start.adam)
        losses, g1 = [], None
        for k in range(steps):
            u, eps = draws[k]
            x = (start.x[idx[k]].to(torch.float32) + u) / 256.0
            wg = [t.requires_grad_() for t in w]
            terms = ref.train_terms(wg, x[:used], [e[:used] for e in eps], c["shape"],
                                    c["nblocks"], c["alpha"], (c["lambda_1"], c["lambda_2"]),
                                    int(cell["solver"]["fixed_steps"]), prec)
            loss = terms.sum() / used
            grads = torch.autograd.grad(loss, wg)
            losses.append(float(loss.detach()))
            if k == 0:
                g1 = [g.detach() for g in grads]
            w, state = ref_cnf.adam_step([t.detach() for t in wg], list(grads), state,
                                         opt["lr"], opt["weight_decay"])
        return dict(losses=losses, g1=g1, p_end=w, adam=state)

    def compare(self, got: dict, want: dict, start, prefix: str) -> dict:
        """:meth:`.fit.Driver.compare`, with each step's loss gap taken over
        the larger of the reference loss and the image's dimension ``D =
        c*h*w``.  A row's loss sums terms of thousands of nats (the logit's
        log-determinant, the normal log-densities) that cancel as training
        takes the loss from positive nats to negative, so its rounding
        follows ``D``, not the sum: over the sum alone the gap grows without
        bound as a loss nears zero."""
        out = super().compare(got, want, start, prefix)
        dim = self.config["shape"][0] * self.config["shape"][1] * self.config["shape"][2]
        out[prefix + "loss_gap"]["value"] = max(
            abs(a - b) / max(abs(b), dim) for a, b in zip(got["losses"], want["losses"]))
        return out
