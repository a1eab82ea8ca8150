"""The multiscale cell (``cifar10-rnode-fit-rk4-adjoint``) through the harness
at a tiny size on the CPU, (3, 8, 8) with hidden widths (8, 8, 8): a sound
run is correct and reads its metrics, the TF32 control and the half-batch
fault fail the check, and the counts and readers give what they state."""

import copy
import json
import time

import pytest
import torch

from port_bench import counts_multiscale, harness, multiscale_readers

NAME = "cifar10-rnode-fit-rk4-adjoint"


def _ctx(trace=False, seed=2**33 + 7):
    import continuousnormalizingflows_tpu_torch as cnf

    entry, cell, config, metrics = harness.resolve(NAME)
    chain = cnf.MultiscaleICNF.create(shape=(3, 8, 8), hidden=(8, 8, 8))
    config = dict(config, shape=[3, 8, 8], hidden=[8, 8, 8],
                  parameters=sum(p.numel() for b in chain.blocks for p in b.net.parameters()))
    cell = copy.deepcopy(cell)
    cell.update(batch=8, rows=16, pool=64)
    cell["solver"]["fixed_steps"] = 2
    cell["check"]["steps"] = 2
    harness.set_precision()
    ctx = harness.Ctx(name=NAME, cell=cell, config=config, seed=seed, seconds=0.5, trace=trace,
                      device=torch.device("cpu"), t_start=time.perf_counter())
    return ctx, metrics


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    ctx, metrics = _ctx(trace)
    rec = harness.run_cell(ctx)
    out = harness.result(ctx, rec, metrics)
    json.dumps(out)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    if trace:
        # the CPU has no device events: the device's two metrics read nothing here
        assert set(out["metrics"]) == {"mfu.train_multiscale", "step_ms_median.train",
                                       "host_ms_per_step.train", "fit_edge_ms_per_call.train"}
        assert rec["trace"]["ranges"]["block"]["spans"] == 6 * 2  # 6 blocks, 2 steps a call
        assert rec["trace"]["ranges"]["adjoint"]["spans"] == 6 * 2
    else:
        assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_the_control_and_the_fault_fail_the_check():
    ctx, _ = _ctx()
    driver = harness.load_module("drivers", "fit_multiscale").Driver(ctx)
    driver.setup()
    harness.run_window(driver, ctx.seconds)
    limits = ctx.cell["check"]["limits"]
    for kind in ("tf32", "half"):
        values = driver.control_readings(kind)
        assert any(v > limits[k] for k, v in values.items()), (kind, values)


def test_the_counts_at_the_configurations_size():
    shapes = counts_multiscale.block_shapes((3, 32, 32), 2)
    assert len(shapes) == 14 and shapes[-1] == (24, 4, 4)
    field = counts_multiscale.field_flops((3, 32, 32), 2, (64, 64, 64), 200)
    assert field == pytest.approx(112.72e9, rel=1e-4)
    step = counts_multiscale.fit_flops_adjoint((3, 32, 32), 2, (64, 64, 64), 200, 16)
    assert step == pytest.approx(14.234e12, rel=1e-4)


def test_the_adjoint_share_reads_its_span_or_nothing():
    """The share reads the backward solves' device-side ranges (the span's, timed by
    device events) over the busy seconds, or nothing."""

    class Ranges:
        def __init__(self, s):
            self.s = s

        def seconds(self):
            return self.s

    rec = {"trace": {"busy_s": 2.0, "ranges": {}}}
    assert multiscale_readers.adjoint_share(rec, Ranges(1.5)) == 0.75
    assert multiscale_readers.adjoint_share(rec, Ranges(None)) is None
    assert multiscale_readers.adjoint_share({}, Ranges(1.5)) is None


def test_device_ranges_leave_the_program_as_it_was_without_a_card(monkeypatch):
    from continuousnormalizingflows_tpu_torch.ops import adjoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    original, ranges = adjoint._backward_solve, multiscale_readers.DeviceRanges()
    with ranges.around(adjoint, "_backward_solve"):
        assert adjoint._backward_solve is original
    with ranges.around(adjoint, "no_such_function"):
        assert not hasattr(adjoint, "no_such_function")
    assert ranges.seconds() is None
