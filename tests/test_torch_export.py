"""The port's serving export (``utils.export``, on ``torch.export``) against
the JAX package's ``log_prob(TEST)`` and the port's own eager entry points;
mirrors ``tests/test_export.py``.

Tolerances: the exported log-density against JAX's rtol 1e-5 (fp32 solves,
sums in another order); against the port's eager call exactly for the
fixed-step solve and rtol 1e-6 for dopri5 (the same operations, captured).
The adaptive solve takes the same steps in all three: NFE, accepted and
rejected steps equal.  The sampler gives the same bits for the same seed,
before and after a save, and equals the eager ``generate`` with a
generator seeded alike (the same draws, the same operations) to rtol 1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu_torch import distributions as tdists
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.models.nets import MLP, Planar
from continuousnormalizingflows_tpu_torch.ops.ode import odeint_device, odeint_dopri5, odeint_fixed
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

# rk4-16 as the JAX package's export tests; rk4-4 where the step count does
# not matter (each step of an unrolled solve adds to the export's trace)
SOLVERS = {"rk4": dict(method="rk4", gradient="backprop", fixed_steps=16),
           "rk4-4": dict(method="rk4", gradient="backprop", fixed_steps=4),
           "dopri5": dict(method="dopri5", rtol=1e-4, atol=1e-4)}


def _pair(solver="rk4-4", nconditions=0, scale=1.0, **kw):
    """The same model in both packages: JAX's init (times ``scale``),
    converted."""
    jicnf = jcnf.ICNF.create(nvariables=2, nconditions=nconditions,
                             solver=JSolver(**SOLVERS[solver]), **kw)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(lambda v: scale * v, jparams)
    ticnf = tcnf.ICNF.create(nvariables=2, nconditions=nconditions,
                             solver=SolverConfig(**SOLVERS[solver]), **kw)
    return jicnf, jparams, ticnf, params_from_jax(jparams)


def _x(n, seed=0, width=2):
    return (0.3 * np.random.default_rng(seed).standard_normal((n, width))).astype(np.float32)


def _counts(st):
    return tuple(int(v) for v in (st.nfe, st.naccept, st.nreject))


@pytest.mark.parametrize("solver", ["rk4", "dopri5"])
def test_logpdf_export_matches_jax_over_batch_sizes(solver):
    # weights x 2 on dopri5: a field that takes 5 steps and rejects one
    jicnf, jparams, ticnf, tparams = _pair(solver, scale=2.0 if solver == "dopri5" else 1.0)
    art = ex._export_logpdf(ticnf, tparams, device="cpu")
    for n in (3, 17):  # two batch sizes through one program
        x = _x(n, n)
        got, nfe, nacc, nrej = art.call(torch.tensor(x))
        want_lp, _a, want_st = jcnf.inference(jicnf, JMode.TEST, jnp.asarray(x), jparams)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-6)
        with torch.no_grad():
            eager_lp, _a, eager_st = tcnf.inference(ticnf, Mode.TEST, torch.tensor(x), tparams)
        assert (int(nfe), int(nacc), int(nrej)) == _counts(eager_st) == _counts(want_st)
        if solver == "rk4":
            torch.testing.assert_close(got, eager_lp, rtol=0, atol=0)
        else:
            assert _counts(eager_st)[1:] == (5, 1)
            torch.testing.assert_close(got, eager_lp, rtol=1e-6, atol=1e-7)


def test_logpdf_artifact_round_trips(tmp_path):
    _j, _jp, ticnf, tparams = _pair("dopri5")
    art = ex.export_logpdf(ticnf, tparams, device="cpu")
    path = str(tmp_path / "logpdf.pt2")
    ex.save_artifact(path, art)
    loaded = ex.load_artifact(path)
    assert loaded.kind == "logpdf" and loaded.device == torch.device("cpu")
    x = torch.tensor(_x(5, 5))
    torch.testing.assert_close(loaded.call(x), art.call(x), rtol=0, atol=0)


def test_logpdf_artifact_runs_with_torch_alone(tmp_path):
    """A process that imports only torch loads and runs the artifact; the
    port is not in its modules."""
    _j, _jp, ticnf, tparams = _pair("dopri5")
    path = str(tmp_path / "logpdf.pt2")
    ex.save_artifact(path, ex.export_logpdf(ticnf, tparams, device="cpu"))
    x = _x(7, 3)
    x_path, out_path = str(tmp_path / "x.npy"), str(tmp_path / "out.npy")
    script = (
        "import sys, numpy as np, torch\n"
        f"x = torch.tensor(np.load({x_path!r}))\n"
        f"out = torch.export.load({path!r}).module()(x)\n"
        "assert not [m for m in sys.modules if m.startswith('continuousnormalizingflows')]\n"
        f"np.save({out_path!r}, out.numpy())\n"
    )
    np.save(x_path, x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", script], check=True, env=env, cwd=str(tmp_path),
                   timeout=300)
    with torch.no_grad():
        want = tcnf.log_prob(ticnf, Mode.TEST, torch.tensor(x), tparams)
    torch.testing.assert_close(torch.tensor(np.load(out_path)), want,
                               rtol=1e-6, atol=1e-7)


def test_conditional_logpdf_export_matches_jax():
    jicnf, jparams, ticnf, tparams = _pair(nconditions=2)
    art = ex.export_logpdf(ticnf, tparams, device="cpu")
    x = _x(6, 1)
    ys = np.tile(np.array([[0.5, -0.5]], np.float32), (6, 1))
    want = jcnf.log_prob(jicnf, JMode.TEST, jnp.asarray(x), jparams, ys=jnp.asarray(ys))
    np.testing.assert_allclose(art.call(torch.tensor(x), torch.tensor(ys)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


def test_export_with_logistic_base_matches_jax():
    from continuousnormalizingflows_tpu import distributions as jdists

    jicnf = jcnf.ICNF.create(nvariables=2, naugments=0, lambda_3=0.0,
                             base_dist=jdists.logistic(), solver=JSolver(**SOLVERS["rk4-4"]))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    ticnf = tcnf.ICNF.create(nvariables=2, naugments=0, lambda_3=0.0,
                             base_dist=tdists.logistic(),
                             solver=SolverConfig(**SOLVERS["rk4-4"]))
    art = ex.export_logpdf(ticnf, params_from_jax(jparams), device="cpu")
    x = _x(5, 1)
    np.testing.assert_allclose(art.call(torch.tensor(x)).numpy(),
                               np.asarray(jcnf.log_prob(jicnf, JMode.TEST, jnp.asarray(x),
                                                        jparams)), rtol=1e-5, atol=1e-6)


def test_planar_net_exports():
    cfg = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**SOLVERS["dopri5"])).config
    icnf = tcnf.ICNF(cfg, Planar(cfg.n_in, cfg.n_out))
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    art = ex.export_logpdf(icnf, params, device="cpu")
    x = torch.tensor(_x(9, 2))
    with torch.no_grad():
        torch.testing.assert_close(art.call(x), tcnf.log_prob(icnf, Mode.TEST, x, params),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("solver", ["rk4-4", "dopri5"])
def test_sampler_export_is_deterministic_and_equals_generate(tmp_path, solver):
    _j, _jp, ticnf, tparams = _pair(solver)
    art = ex.export_sampler(ticnf, tparams, 16, device="cpu")
    s = art.call(7)
    assert s.shape == (16, 2) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(art.call(7), s, rtol=0, atol=0)
    assert not torch.equal(art.call(8), s)
    with torch.no_grad():
        want = tcnf.generate(ticnf, Mode.TEST, tparams, torch.Generator().manual_seed(7), 16,
                             trace_free=True)
    torch.testing.assert_close(s, want, rtol=1e-6, atol=1e-7)
    path = str(tmp_path / "sampler.pt2")
    ex.save_artifact(path, art)
    loaded = ex.load_artifact(path)
    assert loaded.kind == "sampler"
    torch.testing.assert_close(loaded.call(7), s, rtol=0, atol=0)


def test_sampler_with_the_trace_and_its_seed_leaves_the_global_stream():
    _j, _jp, ticnf, tparams = _pair()
    art = ex.export_sampler(ticnf, tparams, 8, trace_free=False, device="cpu")
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    s = art.call(4)
    torch.testing.assert_close(torch.rand(3), before, rtol=0, atol=0)  # fork_rng restored it
    with torch.no_grad():
        want = tcnf.generate(ticnf, Mode.TEST, tparams, torch.Generator().manual_seed(4), 8)
    torch.testing.assert_close(s, want, rtol=1e-6, atol=1e-7)


def test_conditional_sampler_requires_and_bakes_ys():
    _j, _jp, ticnf, tparams = _pair(nconditions=1)
    with pytest.raises(ValueError, match="pass ys"):
        ex.export_sampler(ticnf, tparams, 8, device="cpu")
    s = ex.export_sampler(ticnf, tparams, 8, ys=torch.ones((8, 1)), device="cpu").call(3)
    assert s.shape == (8, 2) and bool(torch.isfinite(s).all())


class _Branchy(torch.nn.Module):
    """A module torch.fx cannot trace (Python control flow on a shape, a
    proxy to fx), which torch.export takes (the feature width is static)."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.lin = torch.nn.Linear(n_in, n_out)

    def forward(self, x):
        y = self.lin(x)
        return torch.tanh(y) if x.shape[-1] > 1 else y


def test_what_does_not_export_raises():
    """What still refuses, each at export time: the exact trace of a
    from_torch net whose graph the written-out forward mode does not cover,
    naming the node's op (an nn.Hardtanh; a module torch.fx cannot trace), in
    a fixed-step and an adaptive solve, whose trace-free sampler exports; an
    activation without a written-out derivative, which names itself; a
    user's sampler that reads the device.  The abm solver, the generic sweep
    of the port's nets and of a from_torch net of the covered ops, the
    Student-t base and ``mesh=`` export (``tests/test_torch_export_rest.py``,
    ``test_torch_export_mesh.py``)."""
    _j, _jp, ticnf, _tp = _pair()
    cfg = ticnf.config
    modules = {"call_module 1 \\(Hardtanh\\)": torch.nn.Sequential(
                   torch.nn.Linear(cfg.n_in, 8), torch.nn.Hardtanh(),
                   torch.nn.Linear(8, cfg.n_out)),
               "torch.fx cannot trace": _Branchy(cfg.n_in, cfg.n_out)}
    for solver in ("rk4-4", "dopri5"):
        for why, module in modules.items():
            wrapped = tcnf.ICNF(dataclasses.replace(cfg, solver=SolverConfig(**SOLVERS[solver])),
                                tcnf.from_torch(module, cfg.n_in, cfg.n_out))
            params = wrapped.init(torch.Generator().manual_seed(0), device="cpu")
            with pytest.raises(NotImplementedError, match=f"does not export: {why}"):
                ex.export_logpdf(wrapped, params, device="cpu")
            with pytest.raises(NotImplementedError, match=f"does not export: {why}"):
                ex.export_sampler(wrapped, params, 4, trace_free=False, device="cpu")
            assert ex.export_sampler(wrapped, params, 4, device="cpu").call(1).shape == (4, 2)
    hard = tcnf.ICNF(cfg, MLP((cfg.n_in, 8, 8, 8, cfg.n_out), activation=F.hardtanh))
    with pytest.raises(NotImplementedError, match="activation hardtanh"):
        ex.export_logpdf(hard, hard.init(torch.Generator().manual_seed(0), device="cpu"),
                         device="cpu")

    def redraw_beyond_two(generator, shape, dtype):  # a rejection loop with a host read
        draw = lambda: torch.randn(shape, generator=tdists.generator_arg(generator),
                                   dtype=dtype, device=generator.device)
        x = draw()
        while bool((x.abs() > 2).any()):
            x = torch.where(x.abs() > 2, draw(), x)
        return x

    truncated = tdists.CustomDist(tdists.standard_normal().logpdf_fn, redraw_beyond_two)
    custom = tcnf.ICNF.create(nvariables=2, naugments=0, lambda_3=0.0, base_dist=truncated,
                              solver=SolverConfig(**SOLVERS["rk4-4"]))
    with pytest.raises(ValueError, match="cannot be exported"):
        ex.export_sampler(custom, custom.init(torch.Generator().manual_seed(0), device="cpu"),
                          4, device="cpu")


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TRAIN_NOREG])
def test_device_loop_refuses_the_training_modes(mode):
    """The device loop serves the exported TEST surfaces only: a training
    mode asked onto it raises rather than leaving the kernels' route."""
    _j, _jp, ticnf, tparams = _pair(fused=True)
    x = torch.as_tensor(_x(4))
    with pytest.raises(ValueError, match="only Mode.TEST"):
        tcnf.log_prob(ticnf, mode, x, tparams, torch.Generator().manual_seed(0),
                      device_loop=True)


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_fixed_step_device_loop_gives_the_unrolled_bits(method):
    """The fixed-step solve as one ``while_loop`` (what an export traces: one
    step, not ``fixed_steps``) against the unrolled eager loop on a tuple
    state: the same stats and bits."""
    cfg = SolverConfig(method=method, gradient="backprop", fixed_steps=7)
    a = torch.tensor([[-3.0, 1.0], [0.5, -2.0]])
    f = lambda t, y, args: (y[0] @ a + torch.sin(t), -y[1] * y[0].sum())
    y0 = (torch.ones(3, 2), torch.ones(1))
    with torch.no_grad():
        y_e, st_e = odeint_fixed(f, y0, 0.2, 1.0, None, cfg)
        y_d, st_d = odeint_device(f, y0, 0.2, 1.0, None, cfg)
    assert _counts(st_d) == _counts(st_e) and torch.equal(st_d.dt_final, st_e.dt_final)
    for u, v in zip(y_d, y_e):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_device_loop_takes_the_eager_loops_steps(method):
    """``odeint_device`` against the eager loop on a tuple state with a
    stiff-ish field that rejects steps: the same steps, the same bits."""
    cfg = SolverConfig(method=method, rtol=1e-6, atol=1e-6)
    a = torch.tensor([[-30.0, 1.0], [0.0, -2.0]])
    f = lambda t, y, args: (y[0] @ a + torch.sin(t), -y[1] * y[0].sum())
    y0 = (torch.ones(3, 2), torch.ones(1))
    y_e, st_e = odeint_dopri5(f, y0, 0.0, 1.0, None, cfg)
    with torch.no_grad():
        y_d, st_d = odeint_device(f, y0, 0.0, 1.0, None, cfg)
    assert _counts(st_d) == _counts(st_e) and st_e.nreject > 0
    for u, v in zip(y_d, y_e):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    # an exhausted budget poisons the result, as the eager loop does
    short = SolverConfig(method=method, rtol=1e-6, atol=1e-6, max_steps=3)
    with torch.no_grad():
        y_d, st_d = odeint_device(f, y0, 0.0, 1.0, None, short)
    assert _counts(st_d) == _counts(odeint_dopri5(f, y0, 0.0, 1.0, None, short)[1])
    assert all(bool(torch.isnan(v).all()) for v in y_d)
