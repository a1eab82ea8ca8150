"""The scoring cells: ``ICNFDist.logpdf`` of the port in test mode (the exact
trace), one client in a closed loop, each call a batch of held-out rows
taken in turn from a pool made at set-up and timed to its synchronize.

Every call's log-densities are kept.  The check runs the plain reference
over a sample of the window's calls drawn from the seed, the last call
among them, and compares every row of each.
"""

from __future__ import annotations

import time

import torch

from .. import data
from ..reference import cnf as ref
from .fit import build_icnf, widths


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cell, self.config = ctx.cell, ctx.config
        self.batch = int(self.cell["batch"])
        self.pool_calls = int(self.cell["pool_calls"])

    def setup(self) -> None:
        import continuousnormalizingflows_tpu_torch as cnf
        from continuousnormalizingflows_tpu_torch.config import Mode

        ctx, c, dev = self.ctx, self.config, self.ctx.device
        icnf = build_icnf(c, self.cell)
        self.phases = {"imported_s": time.perf_counter() - ctx.t_start}
        self.w0 = data.mlp_weights(ctx.seed, widths(c), dev)
        self.pool = data.synthetic_tabular(ctx.seed, self.pool_calls * self.batch,
                                           c["nvariables"], dev)
        self.dist = cnf.ICNFDist(icnf, data.as_params(self.w0), Mode.TEST)
        self.outs, self.calls = [], 0
        self.phases["data_s"] = time.perf_counter() - ctx.t_start
        with torch.no_grad():  # the call's shapes, warmed
            self.dist.logpdf(self._rows(0))

    def _rows(self, call: int) -> torch.Tensor:
        at = (call % self.pool_calls) * self.batch
        return self.pool[at: at + self.batch]

    def unit(self) -> dict:
        with torch.no_grad():
            lp = self.dist.logpdf(self._rows(self.calls))
        self.outs.append(lp)
        self.calls += 1
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        return {"steps": 1, "rows": self.batch, "bad": 0}

    def attempted(self, window: dict):
        n = len(window["units"])
        bad = int(sum(int(not bool(torch.isfinite(o).all())) for o in self.outs[:n]))
        return n, bad

    def free(self) -> None:
        self.dist = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, n_calls: int) -> list:
        """The calls the check compares: drawn from the seed, the last among them."""
        g = data.generator(self.ctx.seed, "sample", "cpu")
        k = min(int(self.cell["check"]["calls"]), n_calls)
        picked = torch.randperm(n_calls - 1, generator=g)[: k - 1].tolist() if k > 1 else []
        return sorted(set(picked) | {n_calls - 1})

    def reference(self, calls, prec: str) -> dict:
        nz = self.config["n_out"]
        out, stats = [], []
        with torch.no_grad():
            for i in calls:
                lp, st = ref.dopri5_exact_logpdf(self.w0, self._rows(i), nz,
                                                 self.cell["reference_solver"], prec)
                out.append(lp)
                stats.append(st)
        return dict(logpdf=out, stats=stats)

    def compare(self, got: list, want: list) -> dict:
        gap = max(float(torch.max(torch.abs(a - b) / (1.0 + torch.abs(b))))
                  for a, b in zip(got, want))
        lim = self.cell["check"]["limits"]
        return {"logpdf_gap": dict(value=gap, limit=lim["logpdf_gap"])}

    def control_readings(self, kind: str) -> dict:
        """The compared numbers of the program (``"program"``) or of the
        reference in TF32 put in its place (``"tf32"``), against the fp32
        reference, on the calls the check would compare."""
        calls = self.sample(self.calls)
        if getattr(self, "_want", None) is None:
            self._want = self.reference(calls, "fp32")["logpdf"]
        want = self._want
        got = ([self.outs[i] for i in calls] if kind == "program"
               else self.reference(calls, "tf32")["logpdf"])
        return {k: v["value"] for k, v in self.compare(got, want).items()}

    def check(self) -> dict:
        calls = self.sample(self.calls)
        want = self.reference(calls, "fp32")
        got = [self.outs[i] for i in calls]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        return {"ok": finite, "numbers": self.compare(got, want["logpdf"]),
                "notes": {"checked_calls": len(calls), "setup_phases": self.phases,
                          "reference_stats": want["stats"][:3]}}
