"""The port's recorder (``utils/profiling``): spans and host reads that cost
one flag test while no profiler runs, in-memory records on the profiler's
clock while one does, and the counters (kernel launches, the solve's
route, host reads) that are always on.  CPU only: small nets, the plain
versions of the kernels."""

import glob
import json
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import continuousnormalizingflows_tpu_torch as cnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset_counters()
    profiling.records(clear=True)
    yield
    profiling.records(clear=True)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _dist(method="dopri5", b=64):
    icnf = cnf.ICNF.create(nvariables=2, solver=SolverConfig(method=method))
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((b, 2), generator=torch.Generator().manual_seed(1))
    return icnf, params, x


def _named(recs, name):
    return [r for r in recs if r.name == name]


def _inside(recs, parent):
    """The records below ``parent`` (any depth, same thread)."""
    by_id = {r.id: r for r in recs}
    out = []
    for r in recs:
        p = r.parent
        while p is not None and p != parent.id:
            p = by_id[p].parent if p in by_id else None
        if p == parent.id:
            out.append(r)
    return out


class _Guard:
    """The recorder's view of ``torch.autograd.profiler``: the real flag, and
    a ``record_function`` that fails the test (the optimizer enters torch's
    own, so torch's is left alone)."""

    @property
    def _is_profiler_enabled(self):
        return torch.autograd.profiler._is_profiler_enabled

    def record_function(self, *_a, **_k):
        raise AssertionError("entered while no profiler runs")


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("read the clock while no profiler runs")

    monkeypatch.setattr(profiling, "_autograd_profiler", _Guard())
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=boom))
    icnf, params, x = _dist()
    lp = cnf.ICNFDist(icnf, params).logpdf(x)
    model = cnf.ICNFModel(icnf, batchsize=32, epochs=1, device="cpu", log_every=1)
    model.fit(x, params=params)
    assert torch.isfinite(lp).all()
    assert profiling.records() == []
    c = profiling.counters()
    assert c["solve.unfused"] >= 3 and c["host_reads.ode.trial"] > 0
    assert c["host_reads.fit.read"] == 4  # two blocks, the last loss, the stats


def test_on_records_nest_with_their_parents_and_threads():
    seen = {}

    def other():
        with profiling.span("worker"):
            seen["thread"] = threading.get_native_id()

    def body():
        with profiling.span("outer", route="r"):
            with profiling.span("inner"):
                with profiling.host_read("site"):
                    torch.ones(8).sum().item()
            t = threading.Thread(target=other)
            t.start()
            t.join(10)
            assert not t.is_alive()

    _profiled(body)
    recs = profiling.records()
    assert [r.name for r in recs] == ["host_read.site", "inner", "worker", "outer"]
    read, inner, worker, outer = recs
    main = threading.get_native_id()
    assert (read.parent, inner.parent, outer.parent) == (inner.id, outer.id, None)
    assert worker.parent is None and worker.thread == seen["thread"] != main
    assert read.thread == inner.thread == outer.thread == main
    assert outer.route == "r" and inner.route is None
    assert read.read_ms == pytest.approx((read.end_ns - read.start_ns) * 1e-6)
    assert inner.read_ms == outer.read_ms == read.read_ms and worker.read_ms == 0.0
    assert outer.start_ns <= inner.start_ns <= read.start_ns
    assert read.end_ns <= inner.end_ns <= outer.end_ns
    assert profiling.counters() == {"host_reads.site": 1}


@pytest.mark.parametrize("method", ["dopri5", "abm"])
def test_trial_reads_equal_the_solvers_steps(method):
    icnf, params, x = _dist(method)
    _lp, _augs, stats = cnf.inference(icnf, Mode.TEST, x, params)
    steps = int(stats.naccept) + int(stats.nreject)
    _profiled(lambda: cnf.ICNFDist(icnf, params).logpdf(x))
    recs = profiling.records()
    (call,) = _named(recs, "logpdf.call")
    below = _inside(recs, call)
    trials = _named(below, "host_read.ode.trial")
    assert len(trials) == len(_named(below, "ode.trial")) == steps > 0
    # besides the trial steps': the ends copied to the device, and the start's tiny step
    # (dopri5's "auto" start; abm starts from a fixed fraction of the span)
    others = ["host_read.adjoint.times"] + (["host_read.ode.start"] if method == "dopri5" else [])
    reads = [r for r in below if r.name.startswith("host_read.")]
    assert sorted(r.name for r in reads if r not in trials) == others
    assert call.read_ms == pytest.approx(sum(r.read_ms for r in reads))
    (solve,) = _named(below, "solve")
    assert solve.route == "unfused" and solve.parent == call.id
    assert profiling.counters()["host_reads.ode.trial"] == 2 * steps  # unprofiled call too


def _route_call(route):
    g = torch.Generator().manual_seed(2)
    if route == "fused_adaptive":
        icnf = cnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True)
    else:
        icnf = cnf.ICNF.create(
            nvariables=2, fused=route == "fused_rk4",
            solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=4))
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((16, 2), generator=torch.Generator().manual_seed(1))
    if route == "device_loop":
        return lambda: cnf.inference(icnf, Mode.TEST, x, params, device_loop=True)
    if route == "unfused":
        return lambda: cnf.inference(icnf, Mode.TEST, x, params)
    return lambda: cnf.loss(icnf, Mode.TRAIN, x, params, g)


@pytest.mark.parametrize("route", ["fused_adaptive", "fused_rk4", "unfused", "device_loop"])
def test_each_solve_branch_counts_its_route(route):
    call = _route_call(route)
    call()
    assert profiling.counters()[f"solve.{route}"] == 1
    _profiled(call)
    (solve,) = _named(profiling.records(), "solve")
    assert solve.route == route
    assert profiling.counters()[f"solve.{route}"] == 2
    assert not any(profiling.counters().get(f"K{k}.launches") for k in range(1, 7))  # CPU


def test_a_fit_records_its_call_steps_and_reads():
    icnf = cnf.ICNF.create(nvariables=2, fused=True,
                           solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=4))
    x = torch.randn((48, 2), generator=torch.Generator().manual_seed(1))
    model = cnf.ICNFModel(icnf, batchsize=16, epochs=1, device="cpu", log_every=1,
                          steps_per_dispatch=2)
    res, _prof = _profiled(lambda: model.fit(x))
    recs = profiling.records()
    (call,) = _named(recs, "fit.call")
    steps = _named(recs, "fit.step")
    reads = _named(recs, "host_read.fit.read")
    assert res.stats["iterations"] == len(steps) == 3
    assert all(s.parent == call.id for s in steps + reads)
    assert len(reads) == 4  # blocks of 2 and 1 steps, the last loss, the stats
    assert all(r.start_ns >= steps[-1].end_ns for r in reads[1:])
    opt = _named(recs, "optimizer.step")
    assert sorted(o.parent for o in opt) == sorted(s.id for s in steps)
    assert [s.route for s in _named(recs, "solve")] == ["fused_rk4"] * 3
    # inside each step: the solve's float start copied to the device, and its stats' step
    inner = [r for r in recs if r.name in ("host_read.solve.times", "host_read.solve.stats")]
    assert len(inner) == 6 and all(r.parent in {s.id for s in _named(recs, "solve")}
                                   for r in inner)
    assert call.read_ms == pytest.approx(sum(r.read_ms for r in reads + inner))
    assert all(s.read_ms == pytest.approx(sum(r.read_ms for r in _inside(recs, s)
                                              if r.name.startswith("host_read.")))
               for s in steps)
    assert profiling.counters()["host_reads.fit.read"] == 4


def test_a_span_starts_with_the_profilers_event():
    def body():
        for i in range(6):
            with profiling.span(f"mark{i}"):
                torch.ones(64).sum()

    _profiled(body)  # the first record_function of a process is slow: warm it
    offsets = []
    for _attempt in range(3):  # a busy host may preempt a span's entry once
        profiling.records(clear=True)
        _out, prof = _profiled(body)
        events = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.SPAN_PREFIX + "mark")}
        recs = profiling.records()
        assert len(recs) == len(events) == 6
        pairs = [(r, events[profiling.SPAN_PREFIX + r.name]) for r in recs]
        assert all(r.end_ns >= e.start_ns() + e.duration_ns() - 50_000 for r, e in pairs)
        offsets = [r.start_ns - e.start_ns() for r, e in pairs]
        if all(abs(o) < 50_000 for o in offsets):
            break
    assert all(abs(o) < 50_000 for o in offsets), offsets


def test_records_are_capped_and_the_rest_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)

    def body():
        for _ in range(5):
            with profiling.span("s"):
                pass

    _profiled(body)
    assert len(profiling.records()) == 3
    assert profiling.counters()["spans.dropped"] == 2
    assert len(profiling.records(clear=True)) == 3 and profiling.records() == []


def test_the_chrome_trace_holds_the_programs_spans(tmp_path):
    icnf, params, x = _dist()
    with profiling.trace(str(tmp_path)):
        cnf.ICNFDist(icnf, params).logpdf(x)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"cnf.logpdf.call", "cnf.solve", "cnf.ode.trial", "cnf.host_read.ode.trial"} <= names


def test_the_plain_versions_count_no_fp32_tiles():
    """On the CPU the kernels' plain versions run, at widths whose fp32 solves
    and stages take the wide paths on the card (h = 64), and no
    ``wide.f32.*`` counter moves: those count the products the kernel
    library launched on each tile of its fp32 core."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (fused_dynamics_vjp,
                                                                         fused_dynamics_vjp_bwd)
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (fused_solve_rk4,
                                                                      fused_solve_rk4_bwd)

    nz, h, b = 5, 64, 16
    params = MLP((nz + 1, h, h, nz)).init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    u0 = torch.cat([torch.randn((b, nz), generator=g), torch.zeros((b, 3))], dim=-1)
    eps = torch.randn((b, nz), generator=g)
    gbar = torch.randn((b, nz + 3), generator=g)
    args = (u0, eps, None, params, (0.0, 1.0), nz, nz, 2)
    fused_solve_rk4(*args)
    fused_solve_rk4_bwd(*args, gbar)
    x = torch.cat([u0[:, :nz], torch.full((b, 1), 0.5)], dim=-1)
    fused_dynamics_vjp(x, eps, params, nz)
    fused_dynamics_vjp_bwd(x, eps, params, nz, (gbar[:, :nz], gbar[:, :nz], *gbar[:, nz:].T))
    call = _route_call("fused_rk4")
    call()
    assert profiling.counters()["solve.fused_rk4"] == 1
    assert not [k for k in profiling.counters() if k.startswith("wide.f32.")]
