"""The port's parallel layer against the JAX package's sharded step, case by
case as ``tests/test_parallel.py`` (and ``test_dynamics.py``'s sweep-axis
parity): every check runs in 4 gloo ranks on the CPU, started once for the
file (``spawn``, a ``file://`` store, one thread a rank, a join timeout), and
its results are held against JAX on the same inputs, made from a seed with
numpy, with the draws (probes, end time) injected into both packages.

Tolerances are JAX's own for its mesh against one device: the train steps'
loss rtol 2e-4, params rtol 1e-3 / atol 1e-6; the adaptive solve's logp
rtol 1e-4 / atol 1e-5 with the NFE equal; the probe- and sweep-sharded
results rtol 1e-5 / atol 1e-6.  The default stack's gradients are held as
``tests/test_torch_adjoint.py`` holds them against JAX (loss rtol 2e-5 /
atol 2e-4, each gradient within 2e-4 of its largest entry), as are the
tensor-parallel steps' gradients with the probes split over ``model``.
Every rank's solver stats are equal, as are the collective counts of a step
at 2 and 4 ranks.  The entry point's ``graft_entry.dryrun_rank`` runs as one
more case of the 4-rank spawn."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu.config import Mode as JMode
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.config import TraceEstimator as JTrace
from continuousnormalizingflows_tpu.models.nets import MLP as JMLP
from continuousnormalizingflows_tpu.models.nets import DynamicsNet as JDynamicsNet
from continuousnormalizingflows_tpu.ops.dynamics import make_augmented_dynamics as jdyn
import continuousnormalizingflows_tpu_torch.ops.fused_adaptive as fa
from continuousnormalizingflows_tpu_torch.parallel import (data_sharding, host_local_batch,
                                                           make_mesh, replicated)

import _torch_parallel_ranks as ranks

JOIN_S = 120
FAST = JSolver(method="rk4", gradient="backprop", fixed_steps=16)
CASES4 = ["mesh", "roundtrip", "train_step", "adaptive", "grad_auto", "grad_noseminorm",
          "grad_noseminorm22",
          "tp_step", "tp_fused", "probe_axis", "sweep_axis", "estimator", "carry",
          "inventory", "fused_adaptive", "fused_adaptive_partial", "tp_probe", "tp_sweep",
          "tp_noseminorm", "tp_noseminorm_fused", "dryrun", "feature_first"]


def _pack(prefix, layers):
    return {f"{prefix}.{i}.{k}": np.asarray(v, np.float32)
            for i, layer in enumerate(layers) for k, v in layer.items()}


def _inputs():
    """Every case's inputs, from seeded numpy draws and JAX inits."""
    rng = np.random.default_rng(0)
    x64 = (0.4 * rng.standard_normal((64, 2))).astype(np.float32)
    j2 = jcnf.ICNF.create(nvariables=2, solver=FAST)
    cfg = jcnf.ICNFConfig(nvariables=2, solver=FAST)
    j_tp = jcnf.ICNF(config=cfg, net=JMLP((cfg.n_in, 32, 32, cfg.n_out)))
    sweep_cfg = jcnf.ICNFConfig(nvariables=6, naugments=0, lambda_3=0.0, trace=JTrace.EXACT)
    j_sweep = jcnf.ICNF(config=sweep_cfg, net=JMLP((sweep_cfg.n_in, 32, 32, 32,
                                                    sweep_cfg.n_out)))
    j1 = jcnf.ICNF.create(nvariables=1, solver=FAST)
    init = lambda icnf, seed: jax.device_get(icnf.init(jax.random.PRNGKey(seed)))
    out = {
        "train.x": x64, "train.eps": rng.standard_normal((1, 64, 5)).astype(np.float32),
        "train.t1": np.float32(1.04),
        "adaptive.x": x64,
        "grad.x": (0.5 * rng.standard_normal((64, 2))).astype(np.float32),
        "grad.eps": rng.standard_normal((1, 64, 5)).astype(np.float32),
        "grad.t1": np.float32(0.95),
        "tp.x": x64, "tp.eps": rng.standard_normal((1, 64, 5)).astype(np.float32),
        "tp.t1": np.float32(1.02),
        "probe.x": x64[:32], "probe.eps": rng.standard_normal((2, 32, 5)).astype(np.float32),
        "probe.t1": np.float32(0.97),
        "sweep.u": rng.standard_normal((16, sweep_cfg.state_dim)).astype(np.float32),
        "est.x": rng.beta(2.0, 4.0, (256, 1)).astype(np.float32),
        "inv.x": rng.standard_normal((64, 2)).astype(np.float32),
        "carry.x": (0.5 * rng.standard_normal((192, 2))).astype(np.float32),
        "fa.x": (0.5 * rng.standard_normal((512, 2))).astype(np.float32),
        "fa.eps": rng.standard_normal((1, 512, 5)).astype(np.float32),
        "fa.t1": np.float32(1.03),
    }
    out["tpp.eps"] = rng.standard_normal((2, 64, 5)).astype(np.float32)
    for name, icnf, seed in (("train", j2, 0), ("adaptive", j2, 0), ("grad", j2, 3),
                             ("tp", j_tp, 0), ("probe", j2, 0), ("sweep", j_sweep, 0),
                             ("est", j1, 5), ("inv", j2, 1), ("fa", j2, 4), ("carry", j2, 6)):
        out.update(_pack(f"{name}.p", init(icnf, seed)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    inputs = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    got = ranks.spawn(4, CASES4, work, JOIN_S)
    work2 = str(tmp_path_factory.mktemp("parallel2"))
    np.savez(os.path.join(work2, "inputs.npz"), **inputs)
    got["inventory2"] = ranks.spawn(2, ["inventory"], work2, JOIN_S)["inventory"]
    return inputs, got


@pytest.fixture
def inject(monkeypatch):
    def set_draws(eps, t1):
        monkeypatch.setattr(jcore, "sample_probe", lambda cfg, key, b: jnp.asarray(eps))
        monkeypatch.setattr(jcore, "steer_t1", lambda cfg, key: jnp.float32(t1))
    return set_draws


def _layers(d, prefix):
    return [{"w": d[f"{prefix}.{i}.w"], "b": d[f"{prefix}.{i}.b"]}
            for i in range(len([k for k in d if k.startswith(prefix + ".") and k.endswith(".w")]))]


def _rows(per_rank, key):
    return np.concatenate([r[key] for r in per_rank])


def _jax_step(icnf, params, x):
    opt = optax.adam(1e-3)

    def step(p, s):
        l, g = jax.value_and_grad(lambda q: jcnf.loss(icnf, JMode.TRAIN, x, q,
                                                       key=jax.random.PRNGKey(2)))(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), l

    p, l = jax.jit(step)(params, opt.init(params))
    return jax.device_get(p), float(l)


def _held_step(per_rank, p_ref, l_ref):
    for r in per_rank:
        np.testing.assert_allclose(float(r["loss"]), l_ref, rtol=2e-4)
        for a, b in zip(_layers(r, "p"), p_ref):
            np.testing.assert_allclose(a["w"], np.asarray(b["w"]), rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(a["b"], np.asarray(b["b"]), rtol=1e-3, atol=1e-6)


def _same_on_every_rank(per_rank, key):
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r[key], per_rank[0][key])


# ---- the mesh and the params ----

def test_mesh_has_data_and_model_axes(run):
    _inputs_, got = run
    for rank, r in enumerate(got["mesh"]):
        assert tuple(r["shape"]) == (4, 1) and tuple(r["names"]) == ("data", "model")
        assert tuple(r["shape22"]) == (2, 2)
        assert tuple(r["coord22"]) == (rank // 2, rank % 2)


def test_params_round_trip_through_the_model_shards(run):
    """``params_from_jax``, ``shard_mlp_params``, then its inverse: the same
    bits; layer 0 split by output units and layer 1 by input units (the
    port's ``(out, in)`` is JAX's ``(in, out)`` transposed), the rest whole."""
    _inputs_, got = run
    for r in got["roundtrip"]:
        assert bool(r["same"][0])
        assert tuple(r["shapes"]) == (16, 16, 16, 32)


# ---- data parallel ----

def test_sharded_train_step_runs_and_matches(run, inject):
    inputs, got = run
    inject(inputs["train.eps"], inputs["train.t1"])
    icnf = jcnf.ICNF.create(nvariables=2, solver=FAST)
    p_ref, l_ref = _jax_step(icnf, _layers(inputs, "train.p"), jnp.asarray(inputs["train.x"]))
    _held_step(got["train_step"], p_ref, l_ref)
    _same_on_every_rank(got["train_step"], "p.0.w")


def test_sharded_adaptive_solver_consistent(run):
    """Dopri5 at 1e-4 on 4 shards: every rank takes the steps of one device
    on the whole batch (JAX's NFE) and reads the same stats."""
    inputs, got = run
    icnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(method="dopri5", rtol=1e-4,
                                                         atol=1e-4))
    lp, _augs, st = jcnf.inference(icnf, JMode.TEST, jnp.asarray(inputs["adaptive.x"]),
                                   _layers(inputs, "adaptive.p"))
    np.testing.assert_allclose(_rows(got["adaptive"], "lp"), np.asarray(lp), rtol=1e-4,
                               atol=1e-5)
    _same_on_every_rank(got["adaptive"], "stats")
    assert int(got["adaptive"][0]["stats"][0]) == int(st.nfe)


def _close_to_max(got, want, tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("case,seminorm", [("grad_auto", True), ("grad_noseminorm", False),
                                           ("grad_noseminorm22", False)],
                         ids=["seminorm", "no_seminorm", "no_seminorm_2x2"])
def test_sharded_default_stack_gradient(run, inject, case, seminorm):
    """The default stack's loss gradient (dopri5 1e-4, HNW start, backsolve)
    on 4 shards (or 2, each on 2 model ranks that replicate it) equals one
    device's; without the seminorm the parameter VJP enters the backward's
    error norm, and is summed over the ranks at every evaluation so that
    every rank takes one process's steps."""
    inputs, got = run
    inject(inputs["grad.eps"], inputs["grad.t1"])
    icnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(adjoint_seminorm=seminorm))
    (l_j, st), g_j = jax.value_and_grad(
        lambda p: jcnf.loss_with_stats(icnf, JMode.TRAIN, jnp.asarray(inputs["grad.x"]), p,
                                       key=jax.random.PRNGKey(0)), has_aux=True)(
        _layers(inputs, "grad.p"))
    per_rank = got[case]
    _same_on_every_rank(per_rank, "stats")
    _same_on_every_rank(per_rank, "g.layers.0.weight")
    assert int(per_rank[0]["stats"][0]) == int(st.nfe)
    r = per_rank[0]
    np.testing.assert_allclose(float(r["loss"]), float(l_j), rtol=2e-5, atol=2e-4)
    for i, layer in enumerate(g_j):
        _close_to_max(r[f"g.layers.{i}.weight"], np.asarray(layer["w"]).T)
        _close_to_max(r[f"g.layers.{i}.bias"], np.asarray(layer["b"]))
    counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
    assert counts["grad"] == 1 and counts["all_gather"] == 0
    # the forward and the backward solves take one process's trial steps:
    # as many error norms as it takes on the whole batch
    assert counts["norm"] == int(r["norms_whole"][0])
    _held_norms(per_rank, seminorm)
    # the parameter gradient is summed once: at the end with the seminorm,
    # at every backward evaluation without it
    assert (counts["param_vjp"] == 1) == seminorm and counts["param_vjp"] >= 1


def _held_norms(per_rank, seminorm):
    """Each error norm's mean, on every rank, is one process's weighting of
    the parts the ranks hold: every data shard's sum of squares and count
    once (its model ranks hold it alike) and the parameter leaves, alike on
    every rank, once.  Up to the float64 sum of the float32 parts."""
    norms = [r["norms"] for r in per_rank]
    shards = [n for n, r in zip(norms, per_rank) if r["coord"][1] == 0]
    for n in norms[1:]:
        np.testing.assert_array_equal(n[:, 2:], norms[0][:, 2:])  # shared parts, means
    total = sum(n[:, 0] for n in shards) + norms[0][:, 2]
    count = sum(n[:, 1] for n in shards) + norms[0][:, 3]
    np.testing.assert_allclose(norms[0][:, 4], total / count, rtol=1e-6)
    # without the seminorm the parameter leaves are in the backward's norms
    assert (np.max(norms[0][:, 3]) > 0) == (not seminorm)


def test_estimator_with_mesh(run):
    """``ICNFModel(mesh=)`` on 4 ranks trains the unsharded fit's params
    (the same permutation and draws on every rank, the global mean loss);
    ``score`` with the mesh is the unsharded score."""
    _inputs_, got = run
    for r in got["estimator"]:
        np.testing.assert_allclose(r["hist"], r["hist_plain"], rtol=1e-5)
        for a, b in zip(_layers(r, "p"), _layers(r, "plain.p")):
            np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a["b"], b["b"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(r["score"]), float(r["score_plain"]), rtol=1e-5)
    _same_on_every_rank(got["estimator"], "p.0.w")


def test_estimator_with_mesh_carries_the_start(run):
    """``dt0="carry"`` on 4 ranks: each step's solves start from the last
    step's final step size, alike on every rank, and the 3 steps (the
    default stack, 16 rows a rank) are one process's: the same solver stats
    at the last step, losses and params as ``test_torch_train.py`` holds
    the carried fit against JAX's."""
    _inputs_, got = run
    for r in got["carry"]:
        np.testing.assert_array_equal(r["last"][:3], r["last_plain"][:3])
        # the final step size is the step factor ratio^(-1/5) of a norm summed
        # in another order, carried through 3 steps (measured: 6e-5 apart)
        np.testing.assert_allclose(r["last"][3], r["last_plain"][3], rtol=1e-3)
        np.testing.assert_allclose(r["hist"], r["hist_plain"], rtol=1e-5)
        for a, b in zip(_layers(r, "p"), _layers(r, "plain.p")):
            np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a["b"], b["b"], rtol=1e-4, atol=1e-6)
    _same_on_every_rank(got["carry"], "last")


def test_spmd_collective_inventory_does_not_scale_with_devices(run):
    """One step of the adaptive-adjoint fit issues one gradient all-reduce,
    the error norms' reductions inside the trial steps, and no gather; the
    counts are the same at 2 and at 4 ranks."""
    _inputs_, got = run
    c4 = [dict(zip(ranks.COUNT_SITES, r["counts"])) for r in got["inventory"]]
    c2 = [dict(zip(ranks.COUNT_SITES, r["counts"])) for r in got["inventory2"]]
    assert all(c == c4[0] for c in c4 + c2), (c4, c2)
    assert c4[0]["grad"] == 1 and c4[0]["norm"] >= 2 and c4[0]["all_gather"] == 0
    assert c4[0]["param_vjp"] == 1  # the seminorm: q summed once, out of the bucket
    _same_on_every_rank(got["inventory"] + got["inventory2"], "stats")


def test_sharded_fused_adaptive_route(run):
    """K5/K6's route (plain twins on the CPU) on 4 shards of 128 rows: each
    shard is one whole control group, so the solve equals one process's on
    the 512 rows, and the groups' stats fold over the ranks."""
    _inputs_, got = run
    for r in got["fused_adaptive"]:
        assert bool(r["fused"][0])
        np.testing.assert_array_equal(r["stats"], r["stats1"])
        np.testing.assert_allclose(float(r["loss"]), float(r["loss1"]), rtol=1e-6)
        for k in [k for k in r if k.startswith("g.")]:
            np.testing.assert_allclose(r[k], r["g1." + k[2:]], rtol=1e-5, atol=1e-7)
        counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
        assert counts["grad"] == 1 and counts["stats"] == 1 and counts["norm"] == 0


def test_sharded_fused_adaptive_needs_whole_groups(run):
    """``fused_adaptive=True`` on 4 shards of 64 rows: half a control group
    a rank, which one process's groups of the whole batch cannot match, so
    every rank refuses the step and names the rows it needs."""
    _inputs_, got = run
    for r in got["fused_adaptive_partial"]:
        assert "holds 64 rows, it needs a multiple of 128" in str(r["raised"])


@pytest.mark.parametrize("batch,shard,one", [(128, 128, 128), (384, 128, 128), (64, None, 64),
                                             (200, None, None)])
def test_fused_adaptive_tile_on_a_shard(batch, shard, one):
    """A shard takes K5/K6 only as whole 128-row groups and raises otherwise,
    where one process's batch keeps JAX's tiling (a batch of 64 is one
    group of 64)."""
    if shard is None:
        with pytest.raises(ValueError, match=f"holds {batch} rows"):
            fa.fused_adaptive_tile(batch, whole_groups=True)
    else:
        assert fa.fused_adaptive_tile(batch, whole_groups=True) == shard
    assert fa.fused_adaptive_tile(batch) == one


# ---- the model axis ----

@pytest.mark.parametrize("case,fused", [("tp_step", False), ("tp_fused", True)],
                         ids=["unfused", "fused"])
def test_tensor_parallel_train_step_matches(run, inject, case, fused):
    """data 2 x model 2, h = 32 split 16 + 16 (Megatron: layer 0 by its
    output units, layer 1 by its input units): the step equals one device's
    and the params stay split.  ``fused=True`` runs the whole-solve kernel's
    route (its plain twin here) on the shards gathered, as JAX, whose fused
    route is the unfused one on the CPU, runs it too."""
    inputs, got = run
    inject(inputs["tp.eps"], inputs["tp.t1"])
    cfg = jcnf.ICNFConfig(nvariables=2, solver=FAST, fused=fused)
    icnf = jcnf.ICNF(config=cfg, net=JMLP((cfg.n_in, 32, 32, cfg.n_out)))
    p_ref, l_ref = _jax_step(icnf, _layers(inputs, "tp.p"), jnp.asarray(inputs["tp.x"]))
    _held_step(got[case], p_ref, l_ref)
    for r in got[case]:
        assert tuple(r["split"]) == (16, 16)
        counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
        assert counts["grad"] == 1
        if fused:  # the slices gathered before the kernel, no collective inside it
            assert counts["all_gather"] > 0
        else:  # Megatron's all-reduces, no gather
            assert counts["model"] > 0 and counts["all_gather"] == 0


def _prefixed(per_rank, prefix):
    return [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)} for r in per_rank]


def test_feature_first_sharded_steps_match(run, inject):
    """``layout="feature_first"`` on a mesh, each rank transposing its own
    rows: the data-parallel step (4 x 1) and the tensor-parallel one (2 x 2,
    h = 32 split 16 + 16) each equal JAX's feature-first step in one
    process, as the batch-first steps above do."""
    inputs, got = run
    inject(inputs["train.eps"], inputs["train.t1"])
    icnf = jcnf.ICNF.create(nvariables=2, solver=FAST, layout="feature_first")
    p_ref, l_ref = _jax_step(icnf, _layers(inputs, "train.p"), jnp.asarray(inputs["train.x"]))
    dp = _prefixed(got["feature_first"], "dp.")
    _held_step(dp, p_ref, l_ref)
    _same_on_every_rank(dp, "p.0.w")
    inject(inputs["tp.eps"], inputs["tp.t1"])
    cfg = jcnf.ICNFConfig(nvariables=2, solver=FAST, layout="feature_first")
    icnf = jcnf.ICNF(config=cfg, net=JMLP((cfg.n_in, 32, 32, cfg.n_out)))
    p_ref, l_ref = _jax_step(icnf, _layers(inputs, "tp.p"), jnp.asarray(inputs["tp.x"]))
    tp = _prefixed(got["feature_first"], "tp.")
    _held_step(tp, p_ref, l_ref)
    for r in tp:
        assert tuple(r["split"]) == (16, 16)
        counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
        assert counts["grad"] == 1 and counts["model"] > 0 and counts["all_gather"] == 0


def test_probe_axis_sharding_parity(run, inject):
    """Two probes split over ``model`` (data 2 x model 2): the ensemble mean
    is a sum over the ranks, and the logp equals the replicated run's."""
    inputs, got = run
    inject(inputs["probe.eps"], inputs["probe.t1"])
    icnf = jcnf.ICNF.create(nvariables=2, nprobes=2, solver=JSolver(
        method="rk4", gradient="backprop", fixed_steps=8))
    lp, _augs, _st = jcnf.inference(icnf, JMode.TRAIN, jnp.asarray(inputs["probe.x"]),
                                    _layers(inputs, "probe.p"), key=jax.random.PRNGKey(2))
    per_rank = got["probe_axis"]
    # ranks (d, m): the data rank's rows, alike on both model ranks
    np.testing.assert_array_equal(per_rank[0]["lp"], per_rank[1]["lp"])
    np.testing.assert_allclose(np.concatenate([per_rank[0]["lp"], per_rank[2]["lp"]]),
                               np.asarray(lp), rtol=1e-5, atol=1e-6)
    assert dict(zip(ranks.COUNT_SITES, per_rank[0]["counts"]))["model"] > 0


def test_sweep_axis_mesh_parity(run):
    """The exact sweep split over ``model``: each rank sweeps its half of the
    basis rows and the trace is all-reduced; equal to the replicated run."""
    inputs, got = run
    cfg = jcnf.ICNFConfig(nvariables=6, naugments=0, lambda_3=0.0, trace=JTrace.EXACT)
    net = JMLP((cfg.n_in, 32, 32, 32, cfg.n_out))
    du = jdyn(cfg, net, JMode.TEST)(0.3, jnp.asarray(inputs["sweep.u"]),
                                    {"params": _layers(inputs, "sweep.p")})
    for r in got["sweep_axis"]:
        np.testing.assert_allclose(r["du"], np.asarray(du), rtol=1e-5, atol=1e-6)
        assert dict(zip(ranks.COUNT_SITES, r["counts"]))["model"] == 1


def _jax_tp(**kw):
    """JAX's one-device twin of the tensor-parallel cases' h = 32 net."""
    cfg = jcnf.ICNFConfig(nvariables=2, **kw)
    return jcnf.ICNF(config=cfg, net=JMLP((cfg.n_in, 32, 32, cfg.n_out)))


def _held_grads(r, g_j):
    for i, layer in enumerate(g_j):
        _close_to_max(r[f"g.layers.{i}.weight"], np.asarray(layer["w"]).T)
        _close_to_max(r[f"g.layers.{i}.bias"], np.asarray(layer["b"]))


def test_tensor_parallel_with_probe_axis_step_matches(run, inject):
    """data 2 x model 2, h = 32 split 16 + 16, and the 2-probe ensemble
    split over ``model`` too: each rank runs its probe through the whole net
    gathered, and the net's cotangents are summed over the ranks, so the
    gradients and the Adam step equal one device's."""
    inputs, got = run
    inject(inputs["tpp.eps"], inputs["tp.t1"])
    icnf = _jax_tp(nprobes=2, solver=FAST)
    x, p0 = jnp.asarray(inputs["tp.x"]), _layers(inputs, "tp.p")
    p_ref, l_ref = _jax_step(icnf, p0, x)
    g_j = jax.grad(lambda q: jcnf.loss(icnf, JMode.TRAIN, x, q, key=jax.random.PRNGKey(2)))(p0)
    _held_step(got["tp_probe"], p_ref, l_ref)
    for r in got["tp_probe"]:
        _held_grads(r, g_j)
        counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
        assert counts["grad"] == 1 and counts["all_gather"] > 0 and counts["model"] > 0
    _same_on_every_rank(got["tp_probe"], "g.layers.0.weight")


class _Opaque(JDynamicsNet):
    """JAX's net the analytic MLP trace does not take (as
    ``__graft_entry__.dryrun_multichip``'s), around the h = 32 MLP."""

    def __init__(self, net):
        self.net, self.n_in, self.n_out = net, net.n_in, net.n_out

    def init(self, key):
        return self.net.init(key)

    def apply(self, p, xx):
        return self.net.apply(p, xx)


def test_tensor_parallel_with_sweep_axis_inference_matches(run):
    """TEST inference with the exact sweep split over ``model`` (chunks of 2
    basis rows) on the split params of an opaque net: each rank sweeps its
    rows through the whole net gathered; the logp and the steps are one
    device's, alike on the model ranks of a data shard."""
    inputs, got = run
    icnf = _jax_tp(exact_chunk=2, solver=JSolver(method="dopri5", rtol=1e-4, atol=1e-4))
    icnf = jcnf.ICNF(config=icnf.config, net=_Opaque(icnf.net))
    lp, _augs, st = jcnf.inference(icnf, JMode.TEST, jnp.asarray(inputs["tp.x"]),
                                   _layers(inputs, "tp.p"))
    per_rank = got["tp_sweep"]
    for d in (0, 2):
        np.testing.assert_array_equal(per_rank[d]["lp"], per_rank[d + 1]["lp"])
    np.testing.assert_allclose(np.concatenate([per_rank[0]["lp"], per_rank[2]["lp"]]),
                               np.asarray(lp), rtol=1e-5, atol=1e-6)
    _same_on_every_rank(per_rank, "stats")
    assert int(per_rank[0]["stats"][0]) == int(st.nfe)
    counts = dict(zip(ranks.COUNT_SITES, per_rank[0]["counts"]))
    assert counts["all_gather"] > 0 and counts["model"] > 0


def _held_tp_norms(per_rank):
    """Every rank reads the same error norms, each one process's weighting
    of the parts: a data shard's rows once (its model ranks hold them
    alike), the replicated parameter leaves once, and each model rank's
    slices once (alike over ``data``); the backward's norms hold slices."""
    by = {tuple(r["coord"]): r["norms"] for r in per_rank}
    for n in by.values():
        np.testing.assert_array_equal(n[:, 4], by[(0, 0)][:, 4])
    split = by[(0, 0)][:, 6] > 0
    assert split.any() and not split.all()
    total = (by[(0, 0)][:, 0] + by[(1, 0)][:, 0] + by[(0, 0)][:, 2]
             + np.where(split, by[(0, 0)][:, 5] + by[(0, 1)][:, 5], 0.0))
    count = (by[(0, 0)][:, 1] + by[(1, 0)][:, 1] + by[(0, 0)][:, 3]
             + np.where(split, by[(0, 0)][:, 6] + by[(0, 1)][:, 6], 0.0))
    np.testing.assert_allclose(by[(0, 0)][:, 4], total / count, rtol=1e-6)


@pytest.mark.parametrize("case", ["tp_noseminorm", "tp_noseminorm_fused"],
                         ids=["unfused", "fused"])
def test_tensor_parallel_full_adjoint_norm_gradient(run, inject, case):
    """The default stack with ``adjoint_seminorm=False`` under tensor
    parallelism (data 2 x model 2, h = 32 split 16 + 16), fused (K1 + K2's
    plain twins on the net gathered) and not: the parameter VJP enters the
    backward's error norm, each rank's slices summed over ``data`` and the
    norm reduced over every rank in one collective, so every rank takes one
    device's steps and the gradients are one device's."""
    inputs, got = run
    inject(inputs["grad.eps"], inputs["grad.t1"])
    icnf = _jax_tp(solver=JSolver(adjoint_seminorm=False))
    (l_j, st), g_j = jax.value_and_grad(
        lambda p: jcnf.loss_with_stats(icnf, JMode.TRAIN, jnp.asarray(inputs["grad.x"]), p,
                                       key=jax.random.PRNGKey(0)), has_aux=True)(
        _layers(inputs, "tp.p"))
    per_rank = got[case]
    _same_on_every_rank(per_rank, "stats")
    _same_on_every_rank(per_rank, "g.layers.0.weight")
    assert int(per_rank[0]["stats"][0]) == int(st.nfe)
    for r in per_rank:
        np.testing.assert_allclose(float(r["loss"]), float(l_j), rtol=2e-5, atol=2e-4)
        _held_grads(r, g_j)
        counts = dict(zip(ranks.COUNT_SITES, r["counts"]))
        assert counts["grad"] == 1 and counts["param_vjp"] >= 1
        assert counts["norm"] == len(r["norms"])
        assert (counts["all_gather"] > 0) == case.endswith("fused")
    _held_tp_norms(per_rank)


def test_dryrun_multichip_rank_body(run):
    """``graft_entry.dryrun_multichip``'s rank body on 4 gloo ranks (data 2
    x model 2: the tensor-parallel step with the probes split over
    ``model``, the carried-start fit, the sharded exact sweep on the split
    params): finite, the losses alike on every rank, the log-densities
    alike on the model ranks of a data shard."""
    _inputs_, got = run
    per_rank = got["dryrun"]
    by = {tuple(r["coord"]): r for r in per_rank}
    assert set(by) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for r in per_rank:
        assert np.isfinite(r["loss"]) and np.isfinite(r["carry_loss"])
        assert r["lp"].shape == (8,) and np.all(np.isfinite(r["lp"]))
    _same_on_every_rank(per_rank, "loss")
    _same_on_every_rank(per_rank, "carry_loss")
    for d in (0, 1):
        np.testing.assert_array_equal(by[(d, 0)]["lp"], by[(d, 1)]["lp"])


# ---- one process ----

@pytest.fixture
def world_of_one():
    """A mesh of this process alone, the group destroyed afterwards."""
    mesh = make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_host_local_batch_single_process(world_of_one):
    x = torch.arange(64, dtype=torch.float32).reshape(32, 2)
    gx = host_local_batch(world_of_one, x)
    assert gx.shape == (32, 2)
    np.testing.assert_array_equal(gx.numpy(), x.numpy())
    assert data_sharding(world_of_one).axis == "data" and replicated(world_of_one).axis is None


def test_estimator_with_mesh_in_one_process(world_of_one):
    """``ICNFModel(mesh=make_mesh())`` in a plain process trains the
    unsharded fit's bits (a world of 1: every sum is its own)."""
    icnf = tcnf.ICNF.create(nvariables=1, solver=tcnf.SolverConfig(
        method="rk4", gradient="backprop", fixed_steps=16))
    x = np.random.default_rng(0).beta(2.0, 4.0, (256, 1)).astype(np.float32)
    res = tcnf.ICNFModel(icnf, batchsize=64, epochs=2, mesh=world_of_one).fit(x)
    plain = tcnf.ICNFModel(icnf, batchsize=64, epochs=2, device="cpu").fit(x)
    assert np.isfinite(res.stats["final_loss"]) and res.stats["iterations"] == 8
    for k, v in plain.params.items():
        np.testing.assert_array_equal(res.params[k].numpy(), v.numpy())
