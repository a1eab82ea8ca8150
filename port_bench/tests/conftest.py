"""Shared helpers of the benchmark's CPU tests: a cell's run at a tiny size
on the CPU, through the harness, the port's plain versions standing in for
its kernels."""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

# the default net at d = 3 (8 -> 32 -> 32 -> 7)
TINY = dict(nvariables=3, naugments=4, n_in=8, hidden=32, n_out=7)


def tiny_ctx(name: str, seed: int = 2**33 + 7, seconds: float = 0.5, trace: bool = False):
    """A cell's context with its widths, batch and rows cut to a CPU's size."""
    entry, cell, config, metrics = harness.resolve(name)
    config = dict(config, **TINY)
    cell = copy.deepcopy(cell)
    if cell["driver"] == "fit":
        cell.update(batch=128, rows=512)
        cell["check"]["block_rows"] = 128
        if cell["solver"]["method"] == "rk4":
            cell["solver"]["fixed_steps"] = 4
    else:
        cell.update(batch=256, pool_calls=3, trace_units=2)
        cell["check"]["calls"] = 4
    harness.set_precision()
    ctx = harness.Ctx(name=name, cell=cell, config=config, seed=seed,
                      seconds=seconds, trace=trace, device=torch.device("cpu"),
                      world=int(entry["chips"]), t_start=time.perf_counter())
    return ctx, metrics


@pytest.fixture
def run_tiny():
    def run(name, **kw):
        ctx, metrics = tiny_ctx(name, **kw)
        rec = harness.run_cell(ctx)
        return harness.result(ctx, rec, metrics), rec
    return run
