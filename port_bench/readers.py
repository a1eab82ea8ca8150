"""What the metric readers share: the record of a run in the numbers they
report.  A reader returns None where its run holds nothing to read (no
traced section, no span of its kernel, no counter), and the harness then
leaves its metric out of the line.

The record (``rec``) holds ``setup_s``; ``window`` (its ``seconds``,
``steps``, ``rows`` and each unit's); ``spans`` (each spied entry point's
calls and kept results over the window, in a ``--trace 1`` run); ``trace``
(the traced section: ``window_s``, ``busy_s``, ``steps``, ``ranges`` with
each span's device seconds, ``kernels``, ``spans``; over several chips the
times are the ranks' means and ``rank_spans`` each span's seconds by rank
and call);
``ctx`` (the cell and its configuration) and ``counts``.
"""

from __future__ import annotations

import statistics
from typing import Optional

from . import counts


def dims(rec):
    c = rec["ctx"].config
    return c["n_in"], c["hidden"], c["n_out"]


def peak(rec) -> float:
    """The peak of the arithmetic the configuration states: fp32 products
    (precision "highest", TF32 off) run outside the tensor cores."""
    c = rec["ctx"].config
    if c["dtype"] != "float32" or c["precision"] != "highest":
        raise ValueError("only fp32 at precision 'highest' has its peak here")
    return counts.PEAKS["fp32"]


def launch_rows(rec) -> int:
    """Rows of one launch: a rank's share of the minibatch."""
    ctx = rec["ctx"]
    return int(ctx.cell["batch"]) // ctx.world


def rate(rec) -> float:
    w = rec["window"]
    return w["rows"] / w["seconds"]


def _adaptive_rows(groups, b: int):
    """``(nfe_rows, accepted_rows)`` of one K5 launch's per-group stats rows."""
    group = b // len(groups)
    return sum(g[0] for g in groups) * group, sum(g[1] for g in groups) * group


def roofline_pct(rec, kernel: str) -> Optional[float]:
    """The least time of the kernel's launches in the traced section over
    their device seconds, in percent."""
    tr = rec.get("trace")
    span = (tr or {}).get("ranges", {}).get(kernel)
    if not span or span["spans"] == 0 or span["device_s"] <= 0:
        return None
    n_in, h, nz = dims(rec)
    b = launch_rows(rec)
    if kernel in ("K3", "K4"):
        steps = int(rec["ctx"].cell["solver"]["fixed_steps"])
        least = counts.kernel_bounds(n_in, h, nz, b, steps=steps, peak=peak(rec))[kernel][0]
        least *= span["spans"]
    else:
        k5 = tr["spans"].get("K5", {}).get("kept", [])
        if len(k5) != span["spans"]:
            return None
        least = 0.0
        for groups in k5:
            nfe_rows, acc_rows = _adaptive_rows(groups, b)
            least += counts.kernel_bounds(n_in, h, nz, b, nfe_rows=nfe_rows,
                                          accepted_rows=acc_rows, peak=peak(rec))[kernel][0]
    return 100.0 * least / span["device_s"]


def train_flops(rec) -> Optional[float]:
    """The model's operations of the window's train steps (the global batch)."""
    n_in, h, nz = dims(rec)
    cell = rec["ctx"].cell
    w = rec["window"]
    if cell["solver"]["method"] == "rk4":
        return w["steps"] * counts.fit_flops_rk4(n_in, h, nz, int(cell["batch"]),
                                                 int(cell["solver"]["fixed_steps"]))
    k5 = rec.get("spans", {}).get("K5", {}).get("kept", [])
    if len(k5) != w["steps"]:
        return None
    b = launch_rows(rec)
    total = 0.0
    for groups in k5:
        nfe_rows, acc_rows = _adaptive_rows(groups, b)
        total += counts.fit_flops_adaptive(n_in, h, nz, b, nfe_rows, acc_rows)
    return total * rec["ctx"].world


def mfu_pct(rec, flops: Optional[float]) -> Optional[float]:
    if flops is None:
        return None
    w = rec["window"]
    return 100.0 * flops / (w["seconds"] * rec["ctx"].world * peak(rec))


def solve_nfes(rec) -> Optional[list]:
    """Each window call's NFE, from the solver statistics the entry returned."""
    kept = rec.get("spans", {}).get("solve", {}).get("kept", [])
    if not kept or len(kept) != len(rec["window"]["units"]):
        return None
    return [int(s[0]) for s in kept]


def logpdf_flops(rec) -> Optional[float]:
    nfes = solve_nfes(rec)
    if nfes is None:
        return None
    n_in, h, nz = dims(rec)
    return sum(nfes) * counts.exact_eval_flops(n_in, h, nz, int(rec["ctx"].cell["batch"]))


def idle_share(rec) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def step_ms_median(rec) -> Optional[float]:
    units = [u for u in rec["window"]["units"] if u["steps"]]
    if not units:
        return None
    return 1e3 * statistics.median(u["seconds"] / u["steps"] for u in units)


def nfe_per_step(rec) -> Optional[float]:
    k5 = rec.get("spans", {}).get("K5", {}).get("kept", [])
    if not k5:
        return None
    return statistics.fmean(max(g[0] for g in groups) for groups in k5)


def bucket_ms(rec) -> Optional[list]:
    """Each train step's device ms in the gradient bucket's span (the kernels
    launched inside ``parallel/mesh._reduce_bucket``: the bucket's packing,
    its all-reduce and its unpacking), by step a list by rank."""
    tr = rec.get("trace")
    if not tr or rec["ctx"].world < 2 or not tr.get("steps"):
        return None
    ranks = tr.get("rank_spans", {}).get("bucket")
    if not ranks or any(not r or len(r) != tr["steps"] for r in ranks):
        return None
    steps = [[1e3 * r[i] for r in ranks] for i in range(tr["steps"])]
    if any(min(s) <= 0 for s in steps):
        return None
    return steps


def allreduce_ms_per_step(rec) -> Optional[float]:
    """The bucket's ms a step on the rank that waits least there, the one
    that arrived last, whose collective holds no wait for another rank: the
    least over the ranks, each step's, averaged over the steps."""
    steps = bucket_ms(rec)
    return None if steps is None else statistics.fmean(min(s) for s in steps)


def allreduce_skew_ms_per_step(rec) -> Optional[float]:
    """The spread over the ranks of the bucket's ms, each step's, averaged:
    the first rank's wait at the all-reduce for the last."""
    steps = bucket_ms(rec)
    return None if steps is None else statistics.fmean(max(s) - min(s) for s in steps)


def p95_ms(rec) -> float:
    """The 95th percentile (nearest rank) of the window's call times."""
    secs = sorted(u["seconds"] for u in rec["window"]["units"])
    k = max(0, -(-95 * len(secs) // 100) - 1)
    return 1e3 * secs[k]
