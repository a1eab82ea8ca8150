"""The plain reference against the port, the control and the planted faults,
at a tiny size on the CPU: each cell's run through the harness, the port
taking its kernels' plain versions."""

import json

import pytest
import torch

from port_bench import harness
from port_bench.reference import cnf as ref

from conftest import tiny_ctx

ONE_CHIP = ["d43-fit-rk4-fused", "d8-fit-dopri5-fusedadaptive", "d43-logpdf-dopri5-exact"]
FITS = ["d43-fit-rk4-fused", "d8-fit-dopri5-fusedadaptive"]


@pytest.mark.parametrize("name", ONE_CHIP)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(run_tiny, name, trace):
    out, rec = run_tiny(name, trace=trace)
    json.dumps(out)  # the result line is JSON
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    want = {m["name"] for m in harness.resolve(name)[3]["per_layer" if trace else "end_to_end"]}
    if not trace:
        assert set(out["metrics"]) == want
    else:
        assert set(out["metrics"]) <= want and "busy_s" in out["device"]


@pytest.mark.parametrize("name", ONE_CHIP)
def test_the_control_fails_the_check(name):
    """The reference in TF32 put in the program's place fails a limit."""
    ctx, _ = tiny_ctx(name)
    driver = harness.load_module("drivers", ctx.cell["driver"]).Driver(ctx)
    driver.setup()
    harness.run_window(driver, ctx.seconds)
    driver.free()
    limits = ctx.cell["check"]["limits"]
    program = driver.control_readings("program")
    control = driver.control_readings("tf32")
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


def _break(monkeypatch, fault):
    """Plant ``fault`` in the program's timed path."""
    from continuousnormalizingflows_tpu_torch import dist, train

    if fault == "unchanged":  # each optimizer step leaves the parameters as they were
        step = train.ClippedAdam.step

        def same(self, closure=None):
            keep = [p.detach().clone() for g in self.param_groups for p in g["params"]]
            out = step(self, closure)
            with torch.no_grad():
                for p, k in zip([p for g in self.param_groups for p in g["params"]], keep):
                    p.copy_(k)
            return out

        monkeypatch.setattr(train.ClippedAdam, "step", same)
    elif fault == "half":  # the loss over half of the minibatch, the mean over the rest
        loss_step = train.ICNFModel._loss_step

        def half(self, params, generator, xb, yb, dt0=None):
            return loss_step(self, params, generator, xb[: xb.shape[0] // 2], yb, dt0)

        monkeypatch.setattr(train.ICNFModel, "_loss_step", half)
    elif fault == "window_rows":  # the window's calls take each minibatch's first half twice
        batches = train.ICNFModel._batches
        calls = []

        def repeated(self, generator, n):
            out = batches(self, generator, n)
            calls.append(n)
            if len(calls) > 1:
                h = out.shape[1] // 2
                out = torch.cat([out[:, :h], out[:, :h]], dim=1)
            return out

        monkeypatch.setattr(train.ICNFModel, "_batches", repeated)
    elif fault == "window_state":  # a call given an optimizer state starts from a fresh one
        fit = train.ICNFModel.fit

        def fresh(self, X, Y=None, params=None, opt_state=None, generator=None, **kw):
            return fit(self, X, Y, params=params, opt_state=None, generator=generator, **kw)

        monkeypatch.setattr(train.ICNFModel, "fit", fresh)
    elif fault == "answer":  # one log-density altered where it is produced
        logpdf = dist.ICNFDist.logpdf

        def altered(self, x, generator=None):
            out = logpdf(self, x, generator)
            return torch.cat([out[:1] + 1e-2 * (1 + out[:1].abs()), out[1:]])

        monkeypatch.setattr(dist.ICNFDist, "logpdf", altered)


@pytest.mark.parametrize("name,fault", [(n, f) for n in FITS for f in ("unchanged", "half")]
                         + [("d43-logpdf-dopri5-exact", "answer")])
def test_a_broken_timed_path_is_not_correct(run_tiny, monkeypatch, name, fault):
    _break(monkeypatch, fault)
    out, _ = run_tiny(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in FITS
                                        for f in ("window_rows", "window_state")])
def test_a_fault_in_the_window_alone_is_not_correct(run_tiny, monkeypatch, name, fault):
    """A fault that set-up's call does not show (the window's later calls'
    rows, or the optimizer state they continue) fails the window's check."""
    _break(monkeypatch, fault)
    out, _ = run_tiny(name)
    checks = out["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in checks
               if not k.startswith("window_")), checks
    assert not out["correct"], checks


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3e-39])
    got = ref.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, got[5].item()]
    assert ref.to_tf32(got).equal(got)


def test_reference_gradients_match_finite_differences():
    """The reference's train loss is differentiable through its solve: the
    first weight's gradient against a central difference in float64."""
    g = torch.Generator().manual_seed(3)
    w = [t.double() for t in (torch.randn(6, 4, generator=g) * 0.5, torch.zeros(6),
                              torch.randn(6, 6, generator=g) * 0.4, torch.zeros(6),
                              torch.randn(3, 6, generator=g) * 0.4, torch.zeros(3))]
    x = torch.randn(5, 1, generator=g).double()
    eps = torch.randn(5, 3, generator=g).double()
    t1 = torch.tensor(1.05, dtype=torch.float64)
    mm_fp64 = ref.mm

    def loss(ws):
        return ref.rk4_train_terms(ws, x, eps, t1, 1, 3, (0.01, 0.01, 0.01), 4).mean()

    ws = [t.clone().requires_grad_() for t in w]
    (grad,) = torch.autograd.grad(loss(ws), [ws[0]])
    h = 1e-6
    for i, j in ((0, 0), (3, 2), (5, 1)):
        up = [t.clone() for t in w]
        dn = [t.clone() for t in w]
        up[0][i, j] += h
        dn[0][i, j] -= h
        fd = (loss(up) - loss(dn)) / (2 * h)
        assert float(grad[i, j]) == pytest.approx(float(fd), rel=1e-5, abs=1e-9)
    assert mm_fp64 is ref.mm
