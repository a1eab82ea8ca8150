"""The readers of the multiscale cell's own metrics (``readers.py``'s counts
are the MLP's).  Each returns None where its run holds nothing to read."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from . import counts_multiscale, readers


def train_flops(rec) -> float:
    """The chain's model operations of the window's train steps."""
    c, cell = rec["ctx"].config, rec["ctx"].cell
    stages = 4 * int(cell["solver"]["fixed_steps"])
    return rec["window"]["steps"] * counts_multiscale.fit_flops_adjoint(
        c["shape"], c["nblocks"], c["hidden"], int(cell["batch"]), stages)


def mfu_pct(rec) -> Optional[float]:
    if not rec["window"]["steps"]:
        return None
    return readers.mfu_pct(rec, train_flops(rec))


class DeviceRanges:
    """Each call's device-side range of a wrapped function of the program:
    from a CUDA event put on the calling thread's stream as the call starts
    to one put there as it returns.  The range holds the kernels the call
    launched (one stream), whichever host thread ran it and whichever
    thread the profiler stamps on its launches (a CUDA graph's launch that
    waits for queue space on the autograd thread is stamped with the main
    thread's), and any device idle inside the call."""

    def __init__(self) -> None:
        self.pairs: list = []

    @contextlib.contextmanager
    def around(self, module, attr: str):
        """``module.attr`` wrapped while the block runs (unwrapped where the
        module lacks it or there is no card)."""
        original = getattr(module, attr, None)
        if original is None or not torch.cuda.is_available():
            yield
            return

        def wrapped(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = original(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(module, attr, wrapped)
        try:
            yield
        finally:
            setattr(module, attr, original)

    def seconds(self) -> Optional[float]:
        """The ranges' device seconds, summed; None where none was recorded."""
        if not self.pairs:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) * 1e-3


# the continuous adjoint's backward solves (ops/adjoint._backward_solve) of the
# traced section, which the cell's driver records
ADJOINT = DeviceRanges()


def adjoint_share(rec, ranges: Optional[DeviceRanges] = None) -> Optional[float]:
    """The device seconds of the adjoint's backward solves (their
    device-side ranges, :data:`ADJOINT`) over the traced section's busy
    device seconds."""
    tr = rec.get("trace")
    seconds = (ADJOINT if ranges is None else ranges).seconds()
    if not tr or tr["busy_s"] <= 0 or seconds is None:
        return None
    return seconds / tr["busy_s"]
