"""The program's own spans, as the process that prints the result line
recorded them in its traced section (rank 0's on several chips).

The port keeps them in memory while a profiler runs
(``continuousnormalizingflows_tpu_torch.utils.profiling.records()``): each
span's name, id, parent on its thread, start and end (ns, the profiler's
host clock) and the ms it spent blocked in reads that wait for the device
(``read_ms``).  Every function returns None where there is nothing to read:
no traced section, a port that keeps no such records, or no span of the
name asked for.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

# the records of the traced section: those that start within this many
# section lengths of the last one's end (a process that profiled before
# keeps older records)
SECTIONS = 1.5


def section(rec) -> Optional[list]:
    """The records of the run's traced section, in the order they closed."""
    tr = rec.get("trace")
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    try:
        from continuousnormalizingflows_tpu_torch.utils import profiling

        recs = profiling.records()
    except (ImportError, AttributeError):
        return None
    if not recs:
        return None
    since = max(r.end_ns for r in recs) - int(SECTIONS * tr["window_s"] * 1e9)
    return [r for r in recs if r.start_ns >= since] or None


def named(recs: list, name: str) -> list:
    return [r for r in recs if r.name == name]


def ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def free_ms(r) -> float:
    """A span's ms not blocked in a read that waits for the device."""
    return ms(r) - r.read_ms


def below(recs: list, top) -> list:
    """The records inside ``top``, at any depth (its thread's)."""
    parent: Dict[int, Optional[int]] = {r.id: r.parent for r in recs}
    out = []
    for r in recs:
        p = r.parent
        while p is not None and p != top.id:
            p = parent.get(p)
        if p is not None:
            out.append(r)
    return out


def reads_per_call(rec, call: str) -> Optional[float]:
    """The host reads inside the ``call`` spans over the number of calls."""
    recs = section(rec)
    calls = named(recs, call) if recs else []
    if not calls:
        return None
    reads = sum(r.name.startswith("host_read.") for c in calls for r in below(recs, c))
    return reads / len(calls)


def free_ms_per(rec, name: str) -> Optional[float]:
    """The mean over the ``name`` spans of their ms not blocked in a read."""
    recs = section(rec)
    spans = named(recs, name) if recs else []
    if not spans:
        return None
    return statistics.fmean(free_ms(s) for s in spans)


def fit_edge_ms(rec) -> Optional[float]:
    """The mean over the ``fit.call`` spans of their ms outside their
    ``fit.step`` spans and not blocked in a read: the call's prologue, the
    reads' neighbours and its epilogue, where the device has no work."""
    recs = section(rec)
    calls = named(recs, "fit.call") if recs else []
    if not calls:
        return None
    edges: List[float] = []
    for c in calls:
        steps = [r for r in recs if r.parent == c.id and r.name == "fit.step"]
        edges.append(free_ms(c) - sum(free_ms(s) for s in steps))
    return statistics.fmean(edges)
