"""Profiling: a device trace and a step timer.

Counterpart of ``continuousnormalizingflows_tpu.utils.profiling``.
:func:`trace` records with ``torch.profiler`` (CPU activity, and CUDA
activity where a CUDA device is available) and writes a Chrome trace JSON
into ``logdir`` (open it in Perfetto or ``chrome://tracing``); the JAX
package writes a TensorBoard profile.  :class:`StepTimer` measures
throughput past the first (warm-up) step; the NFE of every solve is in the
``SolverStats`` that ``inference`` returns.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "StepTimer"]


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
