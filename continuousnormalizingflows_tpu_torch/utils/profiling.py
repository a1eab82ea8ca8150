"""Profiling: a device trace, a step timer, and the program's own spans and
counters.

Counterpart of ``continuousnormalizingflows_tpu.utils.profiling``.
:func:`trace` records with ``torch.profiler`` (CPU activity, and CUDA
activity where a CUDA device is available) and writes a Chrome trace JSON
into ``logdir`` (open it in Perfetto or ``chrome://tracing``); the JAX
package writes a TensorBoard profile.  :class:`StepTimer` measures
throughput past the first (warm-up) step; the NFE of every solve is in the
``SolverStats`` that ``inference`` returns.

The recorder marks the port's layers from the inside:

* :func:`span` ``(name)`` around a phase (``fit.step``, ``solve``, ``K4``,
  ...) and :func:`host_read` ``(site)`` around a read that waits for the
  device.  While no ``torch.profiler`` profile is active they test one flag
  and do nothing else.  While one is (:func:`trace`, or any
  ``torch.profiler.profile``), each enters ``record_function("cnf." +
  name)``, so the span sits in the profiler's trace on the timeline of the
  device's kernels, and leaves a :class:`SpanRecord` in memory
  (:func:`records`): its thread, its parent on that thread, its start and
  end on the clock the profiler stamps its host events with, and the ms
  blocked in host reads inside it.
* :func:`count` ``(name, n)`` adds to a process-wide counter, always on:
  ``K1.launches`` ... ``K6.launches`` (CUDA kernel launches),
  ``K6.from_record`` and ``K6.replays`` (a K6 launch that walked K5's record,
  and one that solved the forward again first),
  ``solve.<route>`` (the route ``core._solve`` took), ``host_reads.<site>``
  (every :func:`host_read`), ``wide.f32.<BMxBN>`` (the fp32 products K1-K4's
  wide paths launched on each tile of their product core), ``spans.dropped``
  (records past :data:`MAX_RECORDS`).  :func:`counters` reads them,
  :func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "StepTimer", "span", "host_read", "count", "counters", "reset_counters",
           "records", "SpanRecord", "MAX_RECORDS"]

# records kept in memory; later spans are counted in ``spans.dropped``
MAX_RECORDS = 200_000
SPAN_PREFIX = "cnf."


class SpanRecord(NamedTuple):
    """One closed span.  ``start_ns``/``end_ns``: ns since the epoch, the
    clock of the profiler's host events (``CLOCK_REALTIME``); ``start_ns`` is
    taken across the span's ``record_function`` entry, inside which the
    profiler stamps its event.  ``parent``: the ``id`` of the span open on
    the same thread when this one began, or None.  ``read_ms``: ms blocked
    in :func:`host_read` spans, this one's own and its children's."""

    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    read_ms: float
    route: Optional[str]


_counts: Dict[str, int] = {}
_records: List[SpanRecord] = []
_read_keys: Dict[str, str] = {}
_ids = itertools.count(1)
_local = threading.local()


# the span of a call made while no profiler is active
_OFF = contextlib.nullcontext()


def _thread() -> tuple:
    """This thread's stack of open spans and its id (the OS's, as the
    profiler's trace gives it; read once a thread)."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class _Span:
    __slots__ = ("name", "route", "read", "rf", "id", "parent", "stack", "thread", "start",
                 "blocked")

    def __init__(self, name: str, route: Optional[str], read: bool) -> None:
        self.name, self.route, self.read = name, route, read

    def __enter__(self) -> "_Span":
        stack, self.thread = _thread()
        self.stack = stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.id = next(_ids)
        self.blocked = 0
        self.rf = _autograd_profiler.record_function(SPAN_PREFIX + self.name)
        before = time.time_ns()
        self.rf.__enter__()
        self.start = (before + time.time_ns()) // 2
        return self

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        end = time.time_ns()
        self.stack.remove(self)
        if self.read:
            self.blocked = end - self.start
        parent = self.parent
        if parent is not None:
            parent.blocked += self.blocked
        if len(_records) < MAX_RECORDS:
            _records.append(SpanRecord(self.name, self.id, None if parent is None else parent.id,
                                       self.thread, self.start, end, self.blocked * 1e-6,
                                       self.route))
        else:
            count("spans.dropped")
        return False


def span(name: str, route: Optional[str] = None):
    """``with span("fit.step"): ...``: a phase of the program, recorded
    while a profiler is active (``route``: which way a dispatch went)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, route, False)


def host_read(site: str):
    """``with host_read("ode.trial"): flags.tolist()``: a read that waits
    for the device.  Counts ``host_reads.<site>``; recorded as the span
    ``host_read.<site>`` while a profiler is active."""
    key = _read_keys.get(site)
    if key is None:
        key = _read_keys[site] = "host_reads." + site
    _counts[key] = _counts.get(key, 0) + 1
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span("host_read." + site, None, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter, by name."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


def records(clear: bool = False) -> List[SpanRecord]:
    """The closed spans recorded so far, in the order they closed;
    ``clear=True`` also empties the store."""
    out = list(_records)
    if clear:
        del _records[:len(out)]
    return out


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """``with profiling.trace("traces") as prof: step()``: records the block
    and writes ``<logdir>/<pid>.<ns>.pt.trace.json``; ``prof`` is the
    ``torch.profiler.profile`` (``prof.key_averages()`` for sums by op)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or nested
    tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Throughput past the first step.

    >>> timer = StepTimer(batch=4096)
    >>> for i in range(n):
    ...     out = step(...)
    ...     timer.tick(out)   # waits for `out`; the clock starts at the first tick
    >>> timer.samples_per_sec
    """

    def __init__(self, batch: int) -> None:
        self.batch = batch
        self.steps = 0
        self._t0: Optional[float] = None

    def tick(self, out=None) -> None:
        """End of a step: synchronise the devices of the CUDA tensors in
        ``out``, then start the clock (first tick) or count the step."""
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        else:
            self.steps += 1

    @property
    def seconds_per_step(self) -> float:
        if not self.steps or self._t0 is None:
            return float("nan")
        return (time.perf_counter() - self._t0) / self.steps

    @property
    def samples_per_sec(self) -> float:
        return self.batch / self.seconds_per_step
