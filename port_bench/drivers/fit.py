"""The training cells: ``ICNFModel.fit`` of the port, in calls of one epoch
each.  A ``"continued"`` window passes each call's ``params``, ``opt_state``
and ``generator`` on to the next; a ``"reset"`` window starts every call
from the state set-up left, with the generator passed on (each call other
rows' order and draws), so that an adaptive solver's work does not drift as
training stiffens the field.

Set-up builds one model and drives it from the seed through one call of the
window's own kind (the permutation of the rows, the minibatches gathered
from it, the optimizer's steps chained inside the call) from the seed's
weights; the window continues that same state.  Two checks, each over the
first ``check_steps`` steps of one call: set-up's call, from the weights the
benchmark made, and one of the window's calls, drawn from the seed (the
last, where the window ends before it), from the state the program had at
its start.  For each the plain reference redraws the call's permutation and
draws from the generator's state, gathers the same rows and follows the
steps; it compares each step's loss, the first step's gradient as the
optimizer got it and the parameters' change over the steps, leaf by leaf.
"""

from __future__ import annotations

import copy
import statistics
import time
from typing import List, NamedTuple, Optional

import torch

from .. import data
from ..reference import cnf as ref

# each step's loss logged: a call's steps are one block, so the call still
# reads its losses back once, at its end
LOG_EVERY = 1


class Start(NamedTuple):
    """Where a checked call starts: the weights, the Adam state as the
    reference keeps it (None: fresh) and the generator's state."""

    weights: List[torch.Tensor]
    adam: Optional[dict]
    gen_state: torch.Tensor


def build_icnf(config: dict, cell: dict):
    """The port's ICNF of a configuration and a cell's solver stack and route."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import SolverConfig

    solver = SolverConfig(**cell["solver"])
    icnf = cnf.ICNF.create(nvariables=config["nvariables"], naugments=config["naugments"],
                           lambda_1=config["lambda_1"], lambda_2=config["lambda_2"],
                           lambda_3=config["lambda_3"], steer_rate=config["steer_rate"],
                           solver=solver, precision=config["precision"],
                           fused=cell["route"] in ("fused", "fused_adaptive"),
                           fused_adaptive=cell["route"] == "fused_adaptive")
    widths = (config["n_in"], config["hidden"], config["hidden"], config["n_out"])
    if tuple(icnf.net.widths) != widths or icnf.config.nz != config["n_out"]:
        raise ValueError(f"the port's net is {icnf.net.widths}, the configuration states "
                         f"{widths}")
    return icnf


def prepare(ctx) -> None:
    """Before a cell's ranks start: the kernels' library, built once (a
    checkout's first run builds it) rather than by every rank at once."""
    if ctx.device.type == "cuda":
        from continuousnormalizingflows_tpu_torch.ops import _build

        _build.kernels()


def widths(config: dict):
    return (config["n_in"], config["hidden"], config["hidden"], config["n_out"])


def leaf_gap(got: List[torch.Tensor], want: List[torch.Tensor], keep=None) -> float:
    """The worst leaf's gap of norms, ``| |got| - |want| |``, over the larger
    of the leaf's reference norm and the median leaf's (leaves not in
    ``keep`` left out)."""
    g = [float(torch.linalg.vector_norm(t.double())) for t in got]
    w = [float(torch.linalg.vector_norm(t.double())) for t in want]
    med = statistics.median(w)
    idx = range(len(w)) if keep is None else keep
    return max(abs(g[i] - w[i]) / max(w[i], med) for i in idx)


def adam_state(opt_state: dict) -> dict:
    """A copy of the port's Adam ``state_dict()`` as the reference keeps it."""
    st = opt_state["state"]
    keys = sorted(st)
    return {"t": int(st[keys[0]]["step"]),
            "m": [st[i]["exp_avg"].detach().clone() for i in keys],
            "v": [st[i]["exp_avg_sq"].detach().clone() for i in keys]}


class StepRecorder:
    """While entered: the gradients that the optimizer gets at its first step
    and the parameters after its ``steps``-th (PyTorch's global optimizer
    step hooks; a step that calls a hooked parent's counts once)."""

    def __init__(self, steps: int) -> None:
        self.steps, self.depth, self.done = steps, 0, 0
        self.grads = self.params = None

    @staticmethod
    def _leaves(opt) -> List[torch.Tensor]:
        return [p for g in opt.param_groups for p in g["params"]]

    def _pre(self, opt, args, kwargs) -> None:
        if self.depth == 0 and self.done == 0:
            self.grads = [p.grad.detach().clone() for p in self._leaves(opt)]
        self.depth += 1

    def _post(self, opt, args, kwargs) -> None:
        self.depth -= 1
        if self.depth == 0:
            self.done += 1
            if self.done == self.steps:
                self.params = [p.detach().clone() for p in self._leaves(opt)]

    def __enter__(self) -> "StepRecorder":
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        self.handles = [register_optimizer_step_pre_hook(self._pre),
                        register_optimizer_step_post_hook(self._post)]
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cell, self.config = ctx.cell, ctx.config
        self.batch = int(self.cell["batch"])  # the global minibatch
        self.rows = int(self.cell["rows"])
        self.check_steps = int(self.cell["check"]["steps"])
        # the window's checked call: one of its first few, drawn from the seed
        g = data.generator(ctx.seed, "sample", "cpu")
        self.check_unit = int(torch.randint(int(self.cell["check"]["window_units"]), (1,),
                                            generator=g))
        self.units, self.in_window, self.window_got = 0, True, None
        self._want = {}

    def _data(self) -> None:
        ctx, c = self.ctx, self.config
        self.train_x = data.synthetic_tabular(ctx.seed, self.rows, c["nvariables"], ctx.device)
        self.w0 = data.mlp_weights(ctx.seed, widths(c), ctx.device)
        self.setup_start = Start(self.w0, None,
                                 data.generator(ctx.seed, "train", ctx.device).get_state())

    def _fit(self, params, opt_state, gen, record: bool):
        """One call of the window's kind; with ``record``, what the check reads of it."""
        if not record:
            return self.model.fit(self.train_x, params=params, opt_state=opt_state,
                                  generator=gen), None
        with StepRecorder(self.check_steps) as r:
            res = self.model.fit(self.train_x, params=params, opt_state=opt_state,
                                 generator=gen)
        if len(res.history) != self.rows // self.batch or r.params is None:
            raise RuntimeError(f"a call ran {len(res.history)} steps, the check reads "
                               f"{self.check_steps}")
        return res, dict(losses=res.history[: self.check_steps], g1=r.grads, p_end=r.params)

    def setup(self) -> None:
        import continuousnormalizingflows_tpu_torch as cnf

        ctx = self.ctx
        icnf = build_icnf(self.config, self.cell)
        self.phases = {"imported_s": time.perf_counter() - ctx.t_start}
        self._data()
        self.phases["data_s"] = time.perf_counter() - ctx.t_start
        opt = self.cell["optimizer"]
        self.model = cnf.ICNFModel(
            icnf, optimizer=cnf.default_optimizer(opt["lr"], opt["weight_decay"]),
            batchsize=self.batch, epochs=1, log_every=LOG_EVERY,
            steps_per_dispatch=self.rows // self.batch, mesh=ctx.mesh,
            device=None if ctx.mesh is not None else ctx.device)
        gen = data.generator(ctx.seed, "train", ctx.device)
        res, self.setup_got = self._fit(data.as_params(self.w0), None, gen, record=True)
        self.phases["call_s"] = time.perf_counter() - ctx.t_start
        self.state = (res.params, res.opt_state, res.generator)
        # a "reset" window starts every fit call from the set-up's state; fit's
        # optimizer updates the moments it is given in place, so each call gets a copy
        self.start = (res.params, copy.deepcopy(res.opt_state))

    def setup_reference_only(self) -> None:
        """What the reference needs of a set-up, without the program: the
        rows, the weights and the generator's state; the window's checked
        call is taken as the one after set-up's, from the reference's own
        state at the end of set-up's call."""
        self._data()
        c = self.config
        steps = self.rows // self.batch
        end = self.follow(self.setup_start, "fp32", steps=steps)
        _, _, gen_state = ref.fit_call_draws(self.setup_start.gen_state, self.ctx.device,
                                             self.rows, self.batch, steps, c["n_out"],
                                             c["steer_rate"])
        self.window_got = dict(start=Start(end["p_end"], end["adam"], gen_state))
        self.model = self.state = None

    def unit(self) -> dict:
        params, opt_state, gen = self.state
        if self.cell["window"] == "reset":
            params, opt_state = self.start[0], copy.deepcopy(self.start[1])
        record = self.in_window and self.ctx.rank == 0 and self.units <= self.check_unit
        if record:
            start = Start([v.detach() for v in params.values()], adam_state(opt_state),
                          gen.get_state())
        res, got = self._fit(params, opt_state, gen, record)
        if record:
            self.window_got = dict(got, start=start, unit=self.units)
        self.units += 1
        self.state = (res.params, res.opt_state, res.generator)
        steps = int(res.stats["iterations"])
        finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                         res.history + [res.stats["final_loss"]]))
        return {"steps": steps, "rows": steps * self.batch, "bad": 0 if finite else steps,
                "nfe_last": res.stats.get("nfe")}

    def window_closed(self) -> None:
        self.in_window = False

    def attempted(self, window: dict):
        return window["steps"], window["bad"]

    def free(self) -> None:
        self.state = self.model = self.start = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----

    def follow(self, start: Start, prec: str, rows: int = 0, steps: int = 0) -> dict:
        """The plain reference over the first ``steps`` (default: the check's)
        steps of a call from ``start``: each step's loss, the first step's
        gradient, and the weights and Adam state at the end.  ``rows``: the
        loss over the first ``rows`` of each minibatch only (a planted fault:
        the rest of the batch left out), 0 for all of them."""
        c, cell, dev = self.config, self.cell, self.ctx.device
        nz, d, b = c["n_out"], c["nvariables"], self.batch
        steps = steps or self.check_steps
        used = rows or b
        lambdas = (c["lambda_1"], c["lambda_2"], c["lambda_3"])
        opt = cell["optimizer"]
        block = int(cell["check"]["block_rows"])
        idx, draws, _ = ref.fit_call_draws(start.gen_state, dev, self.rows, b, steps, nz,
                                           c["steer_rate"])
        w = [t.detach().clone() for t in start.weights]
        state = None if start.adam is None else dict(start.adam)
        losses, g1, stats = [], None, []
        for k in range(steps):
            t1, eps = draws[k]
            x = self.train_x[idx[k]]
            wg = [t.requires_grad_() for t in w]
            grads = [torch.zeros_like(t) for t in w]
            total = 0.0
            for lo in range(0, used, block):
                sl = slice(lo, min(used, lo + block))
                if cell["solver"]["method"] == "rk4":
                    terms = ref.rk4_train_terms(wg, x[sl], eps[sl], t1, d, nz, lambdas,
                                                cell["solver"]["fixed_steps"], prec)
                else:
                    terms, st = ref.dopri5_groups_train_terms(
                        wg, x[sl], eps[sl], t1, d, nz, lambdas, cell["reference_solver"],
                        int(cell["check"]["group"]), prec)
                    stats.append(st)
                part = terms.sum() / used
                for acc, g in zip(grads, torch.autograd.grad(part, wg)):
                    acc += g
                total += float(part.detach())
            losses.append(total)
            if k == 0:
                g1 = grads
            w, state = ref.adam_step([t.detach() for t in wg], grads, state, opt["lr"],
                                     opt["weight_decay"])
        out = dict(losses=losses, g1=g1, p_end=w, adam=state)
        if stats:
            out["nfe_max"] = int(torch.cat(stats)[:, 0].max())
        return out

    def compare(self, got: dict, want: dict, start: Start, prefix: str) -> dict:
        """The compared numbers of one checked call: loss, first gradient,
        change over the steps."""
        lim = self.cell["check"]["limits"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        g_norms = [float(torch.linalg.vector_norm(g.double())) for g in want["g1"]]
        med = statistics.median(g_norms)
        # leaves whose gradient is nought to rounding move by round-off alone
        moved = [i for i, n in enumerate(g_norms) if n >= 1e-3 * med]
        change = lambda p: [a - b for a, b in zip(p, start.weights)]
        values = {"loss_gap": loss_gap, "grad_gap": leaf_gap(got["g1"], want["g1"]),
                  "change_gap": leaf_gap(change(got["p_end"]), change(want["p_end"]), moved)}
        return {prefix + k: dict(value=v, limit=lim[prefix + k]) for k, v in values.items()}

    def _checked(self):
        """``(prefix, start, what the program gave)`` of each checked call."""
        out = [("", self.setup_start, getattr(self, "setup_got", None))]
        w = self.window_got
        if w is not None:
            out.append(("window_", w["start"], w if "losses" in w else None))
        return out

    def control_readings(self, kind: str) -> dict:
        """The compared numbers of the program (``"program"``), of the
        reference in TF32 put in its place (``"tf32"``), or of the reference
        with half of each minibatch left out (``"half"``), each against the
        fp32 reference, for both checked calls."""
        values = {}
        for prefix, start, program in self._checked():
            if prefix not in self._want:
                self._want[prefix] = self.follow(start, "fp32")
            got = {"program": lambda: program, "tf32": lambda: self.follow(start, "tf32"),
                   "half": lambda: self.follow(start, "fp32", rows=self.batch // 2)}[kind]()
            values.update({k: v["value"] for k, v in
                           self.compare(got, self._want[prefix], start, prefix).items()})
        return values

    def check(self) -> dict:
        numbers, notes, finite = {}, {"setup_phases": getattr(self, "phases", {})}, True
        for prefix, start, got in self._checked():
            want = self.follow(start, "fp32")
            finite = finite and all(bool(torch.isfinite(t).all())
                                    for t in got["g1"] + got["p_end"])
            numbers.update(self.compare(got, want, start, prefix))
            notes[prefix + "losses"] = got["losses"]
            notes[prefix + "reference_losses"] = want["losses"]
            if "nfe_max" in want:
                notes[prefix + "reference_nfe_max"] = want["nfe_max"]
        notes["window_checked_call"] = self.window_got.get("unit")
        return {"ok": bool(finite), "numbers": numbers, "notes": notes}
