"""The yardstick's counts at the cells' shapes."""

import pytest

from port_bench import counts


def test_rk4_kernel_bounds_at_d43():
    b = counts.kernel_bounds(88, 352, 87, 8192, steps=32)
    assert b["K3"] == (pytest.approx(10.65e-3, rel=1e-3), "operations")
    assert b["K4"] == (pytest.approx(31.98e-3, rel=1e-3), "operations")


def test_parameters_and_exact_evaluation_at_d43():
    assert counts.param_count(88, 352, 87) == 186_295
    assert counts.exact_eval_flops(88, 352, 87, 65_536) == pytest.approx(40.6e9, rel=1e-3)


def test_adaptive_bounds_scale_with_the_steps_taken():
    one = counts.kernel_bounds(18, 72, 17, 65_536, nfe_rows=20 * 65_536, accepted_rows=3 * 65_536)
    two = counts.kernel_bounds(18, 72, 17, 65_536, nfe_rows=40 * 65_536, accepted_rows=6 * 65_536)
    assert two["K5"][0] == pytest.approx(2 * one["K5"][0], rel=0.01)
    assert two["K6"][0] == pytest.approx(2 * one["K6"][0], rel=0.01)


def test_model_flops_count_no_recompute():
    # the rk4 step's FLOPs are K3's and K4's work together, K4 counting the forward's stages
    b = counts.kernel_bounds(88, 352, 87, 8192, steps=32)
    step = counts.fit_flops_rk4(88, 352, 87, 8192, 32)
    assert step / counts.PEAKS["fp32"] == pytest.approx(b["K4"][0], rel=1e-6)
    adaptive = counts.fit_flops_adaptive(18, 72, 17, 128, 20 * 128, 3 * 128)
    fwd = 2 * (20 * 128 * (counts.stage_fmas(18, 72, 17) - 72 * 17) + 128 * 72 * 17)
    assert fwd < adaptive < fwd + 2 * 6 * 3 * 128 * counts.stage_bwd_fmas(18, 72, 17, 17)


class _Event:
    def __init__(self, name, start, dur, corr=0, thread=1):
        self._n, self._s, self._d, self._c, self._t = name, start, dur, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def test_a_kernel_counts_to_the_span_open_at_its_launch():
    """Attribution by the launch, on any stream: a kernel launched inside the
    bucket's span counts to it even where it runs after the span's device copy
    ends; one launched outside every span counts to none."""
    from port_bench import trace

    cpu = [("user_annotation", _Event("port_bench.bucket", 100, 50, thread=7)),
           ("cuda_runtime", _Event("cudaLaunchKernel", 110, 2, corr=1, thread=7)),
           ("cuda_driver", _Event("cuLaunchKernelEx", 120, 2, corr=2, thread=7)),
           ("cuda_runtime", _Event("cudaLaunchKernel", 200, 2, corr=3, thread=7)),
           ("cuda_runtime", _Event("cudaLaunchKernel", 130, 2, corr=4, thread=8))]
    dev = [_Event("void cat_kernel<float>(int)", 300, 10, corr=1),
           _Event("ncclDevKernel_AllReduce_Sum_f32(x)", 900, 40, corr=2),
           _Event("elementwise", 1000, 5, corr=3),
           _Event("other_thread", 310, 5, corr=4)]
    spans = [_Event("port_bench.bucket", 300, 10)]
    out = trace._span_seconds(dev, cpu, spans)["bucket"]
    assert out["spans"] == 1 and out["kernels"] == 2
    assert out["device_s"] == pytest.approx(50e-9) and out["each"] == [pytest.approx(50e-9)]
    assert set(out["names"]) == {"cat_kernel", "ncclDevKernel_AllReduce_Sum_f32"}


def test_the_bucket_metrics_take_each_steps_last_rank_and_spread():
    """Each step's least time over the ranks (the rank that arrived last
    waits for none) and its spread, averaged over the steps: a rank that is
    last in one step and first in the next moves neither."""
    from types import SimpleNamespace

    from port_bench import readers

    each = [[1e-4, 3e-3], [2e-3, 2e-4], [4e-3, 4e-3], [1e-3, 1e-3]]  # 4 ranks x 2 steps
    rec = {"ctx": SimpleNamespace(world=4),
           "trace": {"steps": 2, "rank_spans": {"bucket": each}}}
    assert readers.allreduce_ms_per_step(rec) == pytest.approx((0.1 + 0.2) / 2)
    assert readers.allreduce_skew_ms_per_step(rec) == pytest.approx((3.9 + 3.8) / 2)
    rec["trace"]["rank_spans"]["bucket"][1] = None
    assert readers.allreduce_ms_per_step(rec) is None
