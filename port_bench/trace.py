"""The traced section of a ``--trace 1`` run, and the spans that the harness
puts around the program's entry points.

The section runs under ``torch.profiler``: CUDA activity always, host
activity where the cell asks for it (the kernel spans need it; a host-bound
cell leaves it off, so that the profiler does not slow its host).  From the
profiler's raw events it takes: the device's busy seconds (the union of the
intervals in which a kernel, copy or fill ran), the device seconds of the
kernels launched inside each span (a kernel is attributed through its
launch to the span open on the host then, through the profiler's copy of
the span on the device's timeline), the device seconds by kernel name, and
the idle gaps between device intervals with what the host was doing then.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

SPAN_PREFIX = "port_bench."
# the device events that are work: kernels, copies and fills (not the
# profiler's device-side copies of host annotations)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that launch: the runtime's and the driver's calls (no label of an idle gap)
LAUNCHERS = ("cuda_runtime", "cuda_driver")


class Spy:
    """Wraps ``module:attr`` of the program while active: counts the calls,
    keeps element ``keep`` of each result (a tuple's; None keeps nothing),
    and with ``ranges`` opens a profiler span ``port_bench.<name>`` around
    each call."""

    def __init__(self, name: str, target: str, keep: Optional[int] = None) -> None:
        self.name = name
        mod, _, attr = target.partition(":")
        self.module = importlib.import_module(mod)
        self.attr = attr
        self.original = getattr(self.module, attr)
        self.keep = keep
        self.ranges = False
        self.calls = 0
        self.kept: List = []

    def __call__(self, *args, **kwargs):
        if self.ranges:
            with torch.profiler.record_function(SPAN_PREFIX + self.name):
                out = self.original(*args, **kwargs)
        else:
            out = self.original(*args, **kwargs)
        self.calls += 1
        if self.keep is not None:
            self.kept.append(out[self.keep])
        return out

    def reset(self, ranges: bool) -> None:
        self.ranges, self.calls, self.kept = ranges, 0, []

    def install(self) -> None:
        setattr(self.module, self.attr, self)

    def remove(self) -> None:
        setattr(self.module, self.attr, self.original)


@contextlib.contextmanager
def spies(specs: List[dict]):
    """The cell's spies (``[{"name", "target", "keep"?}]``), installed for
    the block and removed after it."""
    made = [Spy(s["name"], s["target"], s.get("keep")) for s in specs]
    for s in made:
        s.install()
    try:
        yield {s.name: s for s in made}
    finally:
        for s in reversed(made):
            s.remove()


def _union(intervals) -> List[tuple]:
    merged: List[list] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def profile(fn: Callable[[], None], host: bool) -> dict:
    """``fn()`` once under the profiler; the section's summary (seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) + ([ProfilerActivity.CPU] if host or not cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    dev, cpu, device_spans, kinds = [], [], [], defaultdict(int)
    for e in events:
        kind = _kind(e, DeviceType.CUDA)
        kinds[kind] += 1
        if e.device_type() != DeviceType.CUDA:
            cpu.append((kind, e))
        elif kind in DEVICE_WORK:
            dev.append(e)
        elif kind == "gpu_user_annotation":
            device_spans.append(e)
    intervals = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev]
    merged = _union(intervals)
    busy_ns = sum(end - start for start, end in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[short_name(e.name())] += e.duration_ns() * 1e-9
    ranges = _span_seconds(dev, cpu, device_spans)
    gaps = _idle_gaps(merged, dev, cpu)
    return dict(window_s=window_s, busy_s=busy_ns * 1e-9, kernels=dict(by_name), ranges=ranges,
                gaps=gaps, events=dict(kinds))


def _kind(e, cuda) -> str:
    """The event's kineto activity type, where this torch names it; else
    worked out from the device, the user-annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotation = e.is_user_annotation() if hasattr(e, "is_user_annotation") else (
        name.startswith(SPAN_PREFIX) or "#" in name or name.startswith("ProfilerStep"))
    if e.device_type() == cuda:
        if annotation:
            return "gpu_user_annotation"
        low = name.lower()
        return ("gpu_memcpy" if "memcpy" in low else "gpu_memset" if "memset" in low
                else "kernel")
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def _span_seconds(dev, cpu, device_spans) -> Dict[str, dict]:
    """Device seconds, kernel counts and the heaviest kernels by name of the
    kernels launched inside each ``port_bench.*`` span, its host count, and
    the device seconds of each of its calls in the order they began
    (``each``; kernels attributed through their launch only).
    A kernel counts to the innermost span open on its launching thread when
    the runtime or driver call that launched it ran (matched by the
    profiler's correlation id), whatever stream it ran on.  Where no launch
    is found, to the span whose device-side copy (the profiler's, from the
    first kernel launched inside it to the last one's end) holds it."""
    out: Dict[str, dict] = {}
    host_spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(SPAN_PREFIX):],
                         e.start_thread_id()) for _k, e in cpu if e.name().startswith(SPAN_PREFIX))
    nth = []  # each host span's place among its name's calls
    for _s, _e, name, _t in host_spans:
        rec = out.setdefault(name, dict(device_s=0.0, kernels=0, spans=0, names={}, each=[]))
        nth.append(rec["spans"])
        rec["spans"] += 1
        rec["each"].append(0.0)
    host_starts = [s[0] for s in host_spans]
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                for k, e in cpu if k in LAUNCHERS and e.correlation_id()}
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(SPAN_PREFIX):])
                   for e in device_spans if e.name().startswith(SPAN_PREFIX))
    starts = [s[0] for s in spans]
    for e in dev:
        name = call = None
        launch = launches.get(e.correlation_id())
        if launch is not None:
            at, thread = launch
            # the latest-starting span on the thread that is still open at the launch
            for i in range(bisect.bisect_right(host_starts, at) - 1, -1, -1):
                _h_start, h_end, h_name, h_thread = host_spans[i]
                if h_thread == thread and h_end >= at:
                    name, call = h_name, nth[i]
                    break
        else:
            at, end = e.start_ns(), e.start_ns() + e.duration_ns()
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and end <= spans[i][1]:
                name = spans[i][2]
        if name in out:
            rec = out[name]
            rec["device_s"] += e.duration_ns() * 1e-9
            rec["kernels"] += 1
            if call is not None:
                rec["each"][call] += e.duration_ns() * 1e-9
            k = short_name(e.name())
            rec["names"][k] = rec["names"].get(k, 0.0) + e.duration_ns() * 1e-9
    for rec in out.values():
        rec["names"] = dict(sorted(rec["names"].items(), key=lambda kv: -kv[1])[:4])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:96] or name[:96]


def _idle_gaps(merged, dev, cpu, top: int = 10) -> List[list]:
    """The longest gaps between device intervals, each named by the host
    event open at its middle on the launching thread (host activity on), or
    else by the kernel that ends it."""
    if len(merged) < 2:
        return []
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    first_after = sorted((e.start_ns(), short_name(e.name())) for e in dev)
    starts = [s for s, _ in first_after]
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for k, e in cpu
                  if e.duration_ns() > 0 and k not in LAUNCHERS)
    out = []
    for length, start, end in gaps[:top]:
        mid = (start + end) // 2
        label = None
        # the innermost (latest-starting) host event that spans the gap's middle
        for h_start, h_end, name in reversed(host[:bisect.bisect_right(host, (mid, 2**63, ""))]):
            if h_end >= mid:
                label = f"host: {name}"
                break
        if label is None:
            j = bisect.bisect_left(starts, end)
            label = f"before {first_after[j][1]}" if j < len(first_after) else "after the last kernel"
        out.append([label, length * 1e-9])
    return out
