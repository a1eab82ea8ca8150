"""K5/K6's plain versions (the CPU route of ``fused_solve_dopri5``) against
the JAX package's adaptive whole-solve kernel in interpret mode, mirroring
tests/test_pallas_adaptive.py: the flagship 2-D RNODE (nz = 5, state 8, MLP
6 -> 24 -> 24 -> 5), the fixed start dt0 = 0.01.

Per control group the two run the same controller on the same group norm,
so the per-group step statistics must be equal (no decision of these inputs
sits on a rounding edge), and the values agree to rtol 2e-4 / atol 2e-5 (an
fp32 solve of a few steps, sums in another order).  Gradients per tensor
within 2e-4 of the largest entry: the same discrete backward, summed over
rows, stages and steps in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.ops import pallas_adaptive as pa
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa
from continuousnormalizingflows_tpu_torch.utils import profiling
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 2e-4


def _close_to_max(got, want, tol=GRAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _make(b, nconditions=0, **solver):
    solver = dict(dict(method="dopri5", dt0=0.01), **solver)
    jicnf = jcnf.ICNF.create(nvariables=2, nconditions=nconditions, solver=JSolver(**solver))
    ticnf = tcnf.ICNF.create(nvariables=2, nconditions=nconditions,
                             solver=SolverConfig(**solver), fused=True, fused_adaptive=True)
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    cfg = ticnf.config
    u0 = (0.5 * rng.standard_normal((b, cfg.state_dim))).astype(np.float32)
    eps = rng.standard_normal((b, cfg.nz)).astype(np.float32)
    ys = np.full((b, nconditions), 0.3, np.float32) if nconditions else None
    return jicnf, ticnf, jparams, u0, eps, ys


def _run_both(jicnf, ticnf, jparams, u0, eps, ys, max_nodes=64, grads=True):
    cfg = ticnf.config
    scfg = fa._scfg_tuple(cfg.solver)
    w = np.arange(1.0, cfg.state_dim + 1.0, dtype=np.float32)

    def jsolve(u, e, p):
        return pa.fused_solve_dopri5(u, e, None if ys is None else jnp.asarray(ys), p,
                                     (0.0, 1.0), cfg.nz, cfg.nz, scfg, max_nodes)

    u1_j, rows_j = jax.jit(jsolve)(jnp.asarray(u0), jnp.asarray(eps), jparams)
    u = torch.from_numpy(u0).requires_grad_()
    e = torch.from_numpy(eps).requires_grad_()
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    u1_t, rows_t = fa.fused_solve_dopri5(u, e, None if ys is None else torch.from_numpy(ys), p,
                                         (0.0, 1.0), cfg.nz, cfg.nz, scfg, max_nodes)
    out = dict(u1_j=np.asarray(u1_j), rows_j=np.asarray(rows_j), u1_t=u1_t, rows_t=rows_t)
    if grads:
        g_j = jax.jit(jax.grad(lambda u_, e_, p_: jnp.sum(jsolve(u_, e_, p_)[0] * w),
                               argnums=(0, 1, 2)))(jnp.asarray(u0), jnp.asarray(eps), jparams)
        g_t = torch.autograd.grad(torch.sum(u1_t * torch.from_numpy(w)), [u, e, *p.values()])
        out.update(g_j=g_j, g_t=g_t, keys=list(p))
    return out


def _check(out):
    assert out["rows_t"].shape == (out["rows_j"].shape[0], 4)
    np.testing.assert_array_equal(out["rows_t"][:, :3].numpy(), out["rows_j"][:, :3])
    np.testing.assert_allclose(out["u1_t"].detach().numpy(), out["u1_j"], rtol=RTOL, atol=ATOL)
    if "g_t" in out:
        gu_j, ge_j, gp_j = out["g_j"]
        gu_t, ge_t, *gp_t = out["g_t"]
        _close_to_max(gu_t, gu_j)
        _close_to_max(ge_t, ge_j)
        for a, b in zip(gp_t, params_from_jax(jax.device_get(gp_j)).values()):
            _close_to_max(a, b)


@pytest.mark.parametrize("conditioned", [False, True])
def test_single_group_matches_jax(conditioned):
    """B = 16: one group, one tile in both packages."""
    _check(_run_both(*_make(16, nconditions=2 if conditioned else 0)))


@pytest.mark.parametrize("conditioned", [False, True])
def test_group_of_72_rows_matches_jax(conditioned):
    """B = 72: one control group in both packages (on the card K6 walks it as
    a 64-row block and an 8-row one; the twin and the JAX kernel take it
    whole), stats, values and gradients."""
    _check(_run_both(*_make(72, nconditions=2 if conditioned else 0)))


def _make_band(b, naugments):
    """The JAX package's adaptive band (benchmarks/adaptive_band.py, "h=128
    d=20"): 20 variables, MLP(n_in -> 128 -> 128 -> nz) in true float32, with
    ``naugments`` augmented dimensions (-1: the default 21, the band's own 42
    -> 128 -> 128 -> 41 and state 44; 0: 21 -> 128 -> 128 -> 20, state 23),
    the fixed start dt0 = 0.01."""
    from continuousnormalizingflows_tpu.models.nets import MLP as JMLP

    solver = dict(method="dopri5", dt0=0.01)
    probe = jcnf.ICNF.create(nvariables=20, naugments=naugments, solver=JSolver(**solver))
    widths = (probe.config.n_in, 128, 128, probe.config.n_out)
    jicnf = jcnf.ICNF.create(nvariables=20, naugments=naugments, solver=JSolver(**solver),
                             net=JMLP(widths, precision="highest"))
    ticnf = tcnf.ICNF.create(nvariables=20, naugments=naugments, solver=SolverConfig(**solver),
                             fused=True, fused_adaptive=True,
                             net=tcnf.MLP(widths, precision="highest"))
    jparams = jax.device_get(jicnf.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    cfg = ticnf.config
    u0 = (0.5 * rng.standard_normal((b, cfg.state_dim))).astype(np.float32)
    eps = rng.standard_normal((b, cfg.nz)).astype(np.float32)
    return jicnf, ticnf, jparams, u0, eps, None


@pytest.mark.parametrize("naugments", [0, -1], ids=["21-128-128-20", "42-128-128-41"])
def test_band_widths_match_jax(naugments):
    """The adaptive band's widths (the h ~ 128 nets the fused route is for),
    one group of 16 rows: the twin against the JAX kernel in interpret mode,
    stats, values and gradients.  On the card these widths take K5's and
    K6's cluster path."""
    out = _run_both(*_make_band(16, naugments))
    assert out["rows_t"].shape == (1, 4)
    _check(out)


def test_four_groups_of_eight_match_jax_per_group(monkeypatch):
    """B = 32 as 4 groups of 8 rows on both sides (the JAX test's forced
    8-row tiles): every group matches its JAX tile, stats and values."""
    monkeypatch.setattr(pa, "_FWD_TILE", 8)
    monkeypatch.setattr(pa, "_BWD_TILE", 8)
    monkeypatch.setattr(fa, "_GROUP", 8)
    jicnf, ticnf, jparams, u0, eps, ys = _make(32, rtol=1e-6, atol=1e-6)
    u0 = u0 * np.repeat(np.float32([0.1, 1.0, 8.0, 30.0]), 8)[:, None]  # groups of other scales
    out = _run_both(jicnf, ticnf, jparams, u0, eps, ys)
    assert out["rows_t"].shape == (4, 4)
    assert len({tuple(r) for r in out["rows_j"][:, :3].tolist()}) > 1  # groups differ
    _check(out)


def test_node_overflow_poisons_grads_not_forward():
    jicnf, ticnf, jparams, u0, eps, ys = _make(8, rtol=1e-6, atol=1e-6)
    out = _run_both(jicnf, ticnf, jparams, u0, eps, ys, max_nodes=2, grads=False)
    assert out["rows_t"][0, 1] > 2 and torch.isfinite(out["u1_t"]).all()
    p = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    u1, _ = fa.fused_solve_dopri5(torch.from_numpy(u0), torch.from_numpy(eps), None, p,
                                  (0.0, 1.0), 5, 5, fa._scfg_tuple(ticnf.config.solver), 2)
    grads = torch.autograd.grad(u1.sum(), list(p.values()))
    assert all(torch.isnan(g).all() for g in grads)


def test_max_steps_exhaustion_poisons_forward():
    jicnf, ticnf, jparams, u0, eps, ys = _make(8, rtol=1e-10, atol=1e-10, max_steps=3)
    out = _run_both(jicnf, ticnf, jparams, u0, eps, ys, grads=False)
    assert torch.isnan(out["u1_t"]).all() and np.isnan(out["u1_j"]).all()
    np.testing.assert_array_equal(out["rows_t"][:, :3].numpy(), out["rows_j"][:, :3])
    assert out["rows_t"][0, 0] == 1 + 6 * 3  # the budget of 3 trial steps was spent


def test_twin_backward_reports_its_replay(monkeypatch):
    """The backward's own replay takes the forward's steps (K6 writes the
    same counts, which the card checks against K5's)."""
    monkeypatch.setattr(fa, "_GROUP", 8)
    jicnf, ticnf, jparams, u0, eps, _ys = _make(32)
    cfg = ticnf.config
    scfg = fa._scfg_tuple(cfg.solver)
    p = params_from_jax(jparams)
    args = (torch.from_numpy(u0), torch.from_numpy(eps), None, p, (0.0, 1.0), 5, 5, scfg)
    _u1, rows = fa.fused_solve_dopri5_reference(*args, 8)
    *_g, nacc = fa.fused_solve_dopri5_bwd(*args, 64, torch.ones(32, 8))
    assert nacc.shape == (4,)
    assert nacc.tolist() == rows[:, 1].int().tolist()


# K5's record for K6 (the cluster path, 32 < h <= 128): made only where the
# solve will be taken back and the cluster plan is taken; its shape is
# (max_nodes, 6 stage inputs, nz, B).  The plan itself is the card's
# (_build.cluster_plan), so the decision is held here with the plan's answer
# given: d8's widths at the default 128 nodes, and no record off the path.
@pytest.mark.parametrize("max_nodes, cluster, nz, b, want", [
    (128, 2, 17, 65_536, (128, 6, 17, 65_536)),
    (64, 4, 125, 128, (64, 6, 125, 128)),
    (0, 2, 17, 65_536, None),
    (128, 0, 17, 65_536, None),
    (0, 0, 5, 2048, None),
], ids=["d8", "gate edge", "no backward", "row or tiled path", "neither"])
def test_record_shape_only_for_a_backward_on_the_cluster_path(max_nodes, cluster, nz, b, want):
    assert fa._record_shape(max_nodes, cluster, nz, b) == want


@pytest.mark.parametrize("case", ["grad", "no_grad", "frozen", "u0 only"])
def test_solve_asks_for_a_record_only_where_it_is_taken_back(monkeypatch, case):
    """``fused_solve_dopri5`` tells K5 (``static``'s last entry) whether a
    backward will read its record: with grad mode on and ``u0``, ``eps`` or
    a weight requiring grad; not under ``torch.no_grad`` (where an autograd
    Function's ``needs_input_grad`` still reads True), not with nothing to
    differentiate."""
    jicnf, ticnf, jparams, u0, eps, _ys = _make(16)
    p = params_from_jax(jparams)
    u0, eps = torch.from_numpy(u0), torch.from_numpy(eps)
    if case in ("grad", "no_grad"):
        p = {k: v.requires_grad_() for k, v in p.items()}
    if case == "u0 only":
        u0 = u0.requires_grad_()
    seen = []
    apply = fa._FusedAdaptive.apply
    monkeypatch.setattr(fa._FusedAdaptive, "apply",
                        lambda *args: seen.append(args[5]) or apply(*args))
    scfg = fa._scfg_tuple(ticnf.config.solver)
    with torch.set_grad_enabled(case != "no_grad"):
        u1, _rows = fa.fused_solve_dopri5(u0, eps, None, p, (0.0, 1.0), 5, 5, scfg, 64)
    (static,) = seen
    assert static[3] == 64 and static[-1] == (case in ("grad", "u0 only"))
    assert u1.requires_grad == static[-1]
    weights = list(p.values())
    with torch.set_grad_enabled(case != "no_grad"):
        assert fa._wants_backward(u0, eps, weights) == static[-1]


GATE_CASES = [
    (dict(), Mode.TRAIN),
    (dict(), Mode.TEST),
    (dict(), Mode.TRAIN_NOREG),
    (dict(fused_adaptive=False), Mode.TRAIN),
    (dict(fused=False), Mode.TRAIN),
    (dict(solver=SolverConfig(gradient="quadrature")), Mode.TRAIN),
    (dict(solver=SolverConfig(method="tsit5")), Mode.TRAIN),
    (dict(lambda_2=0.0), Mode.TRAIN),
    (dict(nprobes=2), Mode.TRAIN),
    (dict(nvariables=60, naugments=0), Mode.TRAIN),
    (dict(nvariables=130, naugments=0), Mode.TRAIN),
    (dict(nconditions=3), Mode.TRAIN),
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_gate_matches_jax_without_backend_check(monkeypatch, case):
    kw, mode = GATE_CASES[case]
    kw = dict(dict(nvariables=2, fused=True, fused_adaptive=True), **kw)
    jkw = dict(kw)
    if "solver" in kw:
        jkw["solver"] = JSolver(**dataclasses.asdict(kw["solver"]))
    ticnf = tcnf.ICNF.create(**kw)
    jicnf = jcnf.ICNF.create(**jkw)
    monkeypatch.setattr(pa.jax, "default_backend", lambda: "tpu")
    want = pa.fused_adaptive_applicable(jicnf.config, jicnf.net, JMode(mode.value))
    assert fa.fused_adaptive_applicable(ticnf.config, ticnf.net, mode) == want


def test_wide_net_gate_matches_jax(monkeypatch):
    for h in (128, 136):
        from continuousnormalizingflows_tpu.models.nets import MLP as JMLP

        ticnf = tcnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True,
                                 net=tcnf.MLP((6, h, h, 5)))
        jicnf = jcnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True,
                                 net=JMLP((6, h, h, 5)))
        monkeypatch.setattr(pa.jax, "default_backend", lambda: "tpu")
        assert fa.fused_adaptive_applicable(ticnf.config, ticnf.net, Mode.TRAIN) == \
            pa.fused_adaptive_applicable(jicnf.config, jicnf.net, JMode.TRAIN) == (h <= 128)


@pytest.mark.parametrize("batch", [4, 8, 16, 64, 100, 128, 130, 256, 384, 65_536])
def test_group_rule_matches_jax_tile(batch):
    assert fa.fused_adaptive_tile(batch) == pa.fused_adaptive_tile(batch)


def test_core_route_and_fit_take_the_adaptive_twin():
    """``_solve`` takes the K5 route for a fused-adaptive TRAIN solve (its
    stats folded from the group rows), and ``fit`` trains through it with
    the carry off (inert there)."""
    jicnf, ticnf, jparams, u0, eps, _ys = _make(16)
    p = params_from_jax(jparams)
    launches = lambda: tuple(profiling.counters().get(f"{k}.launches", 0) for k in ("K5", "K6"))
    counts = launches()
    u1, stats = tcore._solve(ticnf, Mode.TRAIN, torch.from_numpy(u0), 0.0, 1.0, p,
                             torch.from_numpy(eps)[None], None)
    want, rows = fa.fused_solve_dopri5(torch.from_numpy(u0), torch.from_numpy(eps), None, p,
                                       (0.0, 1.0), 5, 5, fa._scfg_tuple(ticnf.config.solver),
                                       ticnf.config.solver.dense_max_nodes)
    assert torch.equal(u1, want)
    assert (int(stats.nfe), int(stats.naccept)) == (int(rows[:, 0].max()), int(rows[:, 1].max()))
    carry = dataclasses.replace(ticnf.config, solver=SolverConfig(dt0="carry"))
    model = tcnf.ICNFModel(dataclasses.replace(ticnf, config=carry), batchsize=16, epochs=1,
                           device="cpu")
    assert not model._carry_dt(16) and model._carry_dt(12)
    res = model.fit(torch.from_numpy(u0[:32, :2]), params=p)
    assert res.stats["iterations"] == 1 and np.isfinite(res.stats["final_loss"])
    assert counts == launches()


def test_twin_landing_that_rounds_past_t1_ends_the_group():
    """K5's plain twin (and K5, ``csrc/adaptive.cuh`` ctl_decide) land on t1
    where t + (t1 - t) rounds past it, as the unfused loop does
    (``tests/test_torch_ode_adaptive.py::test_a_landing_that_rounds_past_t1_ends_the_solve``):
    zero weights make a constant field, every trial accepted, one step from
    the fixed start dt0 = the whole span."""
    t0, t1 = np.float32(0.2902631461620331), np.float32(0.905047)
    assert np.float32(t0 + np.float32(t1 - t0)) > t1
    p = {k: torch.zeros_like(v) for k, v in
         tcnf.MLP((6, 24, 24, 5)).init(torch.Generator().manual_seed(0), device="cpu").items()}
    scfg = (1e-4, 1e-4, 1.0, 0.9, 0.2, 10.0, 8)
    u1, rows = fa.fused_solve_dopri5_reference(torch.zeros((16, 8)), torch.ones((16, 5)), None, p,
                                               (float(t0), float(t1)), 5, 5, scfg, 16)
    assert torch.isfinite(u1).all() and rows[0, 1] == 1 and rows[0, 2] == 0
