"""The readers of the program's own spans (``port_bench/program_spans.py``
and the six metrics on it): on made-up records, on each cell's traced run
at a tiny size on the CPU, and on a port that keeps no records."""

import math
from types import SimpleNamespace

import pytest

from port_bench import harness, program_spans

from conftest import tiny_ctx

NEW = {
    "d43-fit-rk4-fused": {"host_ms_per_step.train", "fit_edge_ms_per_call.train"},
    "d8-fit-dopri5-fusedadaptive": {"host_ms_per_step.train_adaptive",
                                    "fit_edge_ms_per_call.train_adaptive"},
    "d43-logpdf-dopri5-exact": {"host_reads_per_call.logpdf", "host_ms_per_call.logpdf"},
}
MS = 1_000_000


def _rec(name, id, parent, start_ms, end_ms, read_ms=0.0):
    return SimpleNamespace(name=name, id=id, parent=parent, thread=1, start_ns=start_ms * MS,
                           end_ns=end_ms * MS, read_ms=read_ms, route=None)


FIT = [  # two steps inside a call of 100 ms, a 5 ms read between them, 2 at the end
    _rec("solve", 3, 2, 12, 20),
    _rec("fit.step", 2, 1, 10, 40),
    _rec("host_read.fit.read", 4, 1, 41, 46, 5.0),
    _rec("fit.step", 5, 1, 50, 90),
    _rec("host_read.fit.read", 6, 1, 95, 97, 2.0),
    _rec("fit.call", 1, None, 0, 100, 7.0),
]
CALLS = [  # two logpdf calls, with 3 and 2 trial reads of 1 ms
    _rec("host_read.ode.trial", 3, 2, 2, 3, 1.0),
    _rec("host_read.ode.trial", 4, 2, 4, 5, 1.0),
    _rec("host_read.ode.trial", 5, 2, 6, 7, 1.0),
    _rec("solve", 2, 1, 1, 8, 3.0),
    _rec("logpdf.call", 1, None, 0, 10, 3.0),
    _rec("host_read.ode.trial", 8, 7, 12, 13, 1.0),
    _rec("host_read.ode.trial", 9, 7, 14, 15, 1.0),
    _rec("solve", 7, 6, 11, 16, 2.0),
    _rec("logpdf.call", 6, None, 10, 20, 2.0),
]


@pytest.fixture
def records(monkeypatch):
    from continuousnormalizingflows_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda clear=False: list(recs))
        return {"trace": {"window_s": 0.2}}
    return use


def test_the_readers_on_made_up_records(records):
    rec = records(FIT)
    assert program_spans.free_ms_per(rec, "fit.step") == pytest.approx(35.0)
    # 100 ms, less 70 in the steps and 7 blocked in reads
    assert program_spans.fit_edge_ms(rec) == pytest.approx(23.0)
    assert program_spans.reads_per_call(rec, "fit.call") == 2
    rec = records(CALLS)
    assert program_spans.reads_per_call(rec, "logpdf.call") == pytest.approx(2.5)
    assert program_spans.free_ms_per(rec, "logpdf.call") == pytest.approx(7.5)


def test_an_older_section_is_left_out(records):
    old = [_rec("logpdf.call", 100, None, -10_000, -9_990)]
    rec = records(old + CALLS)
    assert program_spans.reads_per_call(rec, "logpdf.call") == pytest.approx(2.5)


def test_nothing_to_read_gives_none(records, monkeypatch):
    assert program_spans.fit_edge_ms({"trace": None}) is None
    rec = records([])
    assert program_spans.free_ms_per(rec, "fit.step") is None
    rec = records(CALLS)
    assert program_spans.fit_edge_ms(rec) is None
    assert program_spans.free_ms_per(rec, "fit.step") is None
    from continuousnormalizingflows_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")  # a port that keeps no records
    assert program_spans.reads_per_call({"trace": {"window_s": 1.0}}, "logpdf.call") is None


def _traced(name, **kw):
    from continuousnormalizingflows_tpu_torch.utils import profiling

    profiling.records(clear=True)
    ctx, metrics = tiny_ctx(name, trace=True, **kw)
    rec = harness.run_cell(ctx)
    return harness.result(ctx, rec, metrics), rec


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_cells_traced_run_reports_its_new_metrics(name):
    out, rec = _traced(name)
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW[name]}
    assert set(got) == NEW[name], out["metrics"]
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    if name == "d43-logpdf-dopri5-exact":
        # one a trial step, and the start's two: the span's ends and the HNW start's tiny
        # step copied to the device
        steps = [int(s[1]) + int(s[2]) for s in rec["trace"]["spans"]["solve"]["kept"]]
        assert got["host_reads_per_call.logpdf"] == pytest.approx(sum(steps) / len(steps) + 2)
    else:
        assert got[next(k for k in NEW[name] if k.startswith("fit_edge"))] > 0


def test_the_four_rank_cell_reads_rank_zeros_records():
    name = "d43-fit-rk4-fused-dp4"
    out, _rec = _traced(name, seconds=0.3)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"], out["checks"]
    assert {"host_ms_per_step.train", "fit_edge_ms_per_call.train"} <= set(got)
    assert got["host_ms_per_step.train"] > 0 and got["fit_edge_ms_per_call.train"] > 0
