"""The ranks of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_export_mesh.py``).

This module imports torch and the port only, never JAX: each rank is a
process started with the ``spawn`` method (:func:`spawn`) that joins a gloo
group through a ``file://`` store, reads the cases' inputs from
``inputs.npz``, runs every case it is given in turn and writes each case's
results to ``<case>_r<rank>.npz`` (a failure's traceback to
``error_r<rank>.txt``).  The test files hold the results against the JAX
package's.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

import continuousnormalizingflows_tpu_torch as tcnf
import continuousnormalizingflows_tpu_torch.core as tcore
import continuousnormalizingflows_tpu_torch.ops.ode as tode
from continuousnormalizingflows_tpu_torch import graft_entry
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig, TraceEstimator
from continuousnormalizingflows_tpu_torch.models.nets import MLP
from continuousnormalizingflows_tpu_torch.ops.dynamics import make_augmented_dynamics
from continuousnormalizingflows_tpu_torch.parallel import mesh as pmesh
from continuousnormalizingflows_tpu_torch.parallel import (make_mesh, shard_batch_arrays,
                                                           shard_mlp_params, shard_train_step)
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax

FAST = SolverConfig(method="rk4", gradient="backprop", fixed_steps=16)


def unpack(inputs, prefix):
    """A JAX MLP's ``[{"w", "b"}, ...]`` stored as ``<prefix>.<i>.w``/``.b``."""
    n = len([k for k in inputs if k.startswith(prefix + ".") and k.endswith(".w")])
    return [{"w": inputs[f"{prefix}.{i}.w"], "b": inputs[f"{prefix}.{i}.b"]} for i in range(n)]


def _params(inputs, prefix):
    return {k: v.requires_grad_() for k, v in params_from_jax(unpack(inputs, prefix)).items()}


def _np_params(params):
    return {f"p.{i}.{k}": v for i, layer in enumerate(params_to_jax(params))
            for k, v in layer.items()}


@contextlib.contextmanager
def draws(eps, t1):
    """Every call of the port's samplers returns these draws (the global
    batch's probes and the end time), as the tests inject them into JAX."""
    saved = tcore.sample_probe, tcore.steer_t1
    tcore.sample_probe = lambda cfg, g, b, d: torch.from_numpy(eps)[:, :b]
    tcore.steer_t1 = lambda cfg, g, d: torch.tensor(t1)
    try:
        yield
    finally:
        tcore.sample_probe, tcore.steer_t1 = saved


def _stats(st):
    return np.array([int(st.nfe), int(st.naccept), int(st.nreject)], np.int64)


def _grad_step(icnf, mesh, params, x, mode=Mode.TRAIN, tensor_parallel=False):
    """One sharded step that leaves the gradient of the global mean loss in
    ``.grad`` (an optimizer with no step): ``(loss, stats, counts)``."""
    step = shard_train_step(
        lambda p, g, xs, ys: tcnf.loss_with_stats(icnf, mode, xs, p, g), mesh,
        tensor_parallel=tensor_parallel)
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(x))
    loss, stats = step(params, opt, torch.Generator().manual_seed(0), xl, None)
    return loss, stats, step.counts


# ---- cases ----

def case_mesh(rank, world, inputs):
    mesh = make_mesh(device="cpu")
    mesh22 = make_mesh(data=2, model=2, device="cpu")
    return {"shape": np.array(mesh.shape), "names": np.array(mesh.mesh_dim_names),
            "shape22": np.array(mesh22.shape),
            "coord22": np.array([mesh22.get_local_rank(0), mesh22.get_local_rank(1)])}


def case_train_step(rank, world, inputs):
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=FAST)
    params = _params(inputs, "train.p")
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = shard_train_step(lambda p, g, xs, ys: (tcnf.loss(icnf, Mode.TRAIN, xs, p, g),), mesh)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["train.x"]))
    with draws(inputs["train.eps"], inputs["train.t1"]):
        (loss,) = step(params, opt, torch.Generator().manual_seed(0), xl, None)
    return {"loss": loss.numpy(), **_np_params(params)}


def case_adaptive(rank, world, inputs):
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(method="dopri5", rtol=1e-4,
                                                              atol=1e-4))
    params = params_from_jax(unpack(inputs, "adaptive.p"))
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["adaptive.x"]))
    with pmesh.use_mesh(mesh), torch.no_grad():
        lp, _augs, st = tcnf.inference(icnf, Mode.TEST, xl, params)
    return {"lp": lp.numpy(), "stats": _stats(st)}


@contextlib.contextmanager
def norms_of(into):
    """Every error norm's ``global_mean`` call appended to ``into`` as a row
    ``(total, count, total_shared, count_shared, mean, total_split,
    count_split)`` (dopri5's norms are scalars)."""
    inner = tode.global_mean

    def recorded(total, count, total_shared=0.0, count_shared=0, **split):
        out = inner(total, count, total_shared, count_shared, **split)
        into.append([float(total), count, float(total_shared), count_shared, float(out),
                     float(split.get("total_split", 0.0)), split.get("count_split", 0)])
        return out

    tode.global_mean = recorded
    try:
        yield into
    finally:
        tode.global_mean = inner


def _default_grad(inputs, solver, model=1):
    """The sharded step's loss, gradients and collectives, its error norms'
    parts and means (forward and backward solves), and how many error norms
    one process takes on the whole batch."""
    mesh = make_mesh(model=model, device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=solver)
    params = _params(inputs, "grad.p")
    with draws(inputs["grad.eps"], inputs["grad.t1"]):
        with norms_of([]) as norms:
            loss, st, counts = _grad_step(icnf, mesh, params, inputs["grad.x"])
        whole = _params(inputs, "grad.p")
        with norms_of([]) as norms_whole:
            tcnf.loss(icnf, Mode.TRAIN, torch.from_numpy(inputs["grad.x"]), whole,
                      torch.Generator().manual_seed(0)).backward()
    grads = {f"g.{k}": p.grad.numpy() for k, p in params.items()}
    return {"loss": loss.numpy(), "stats": _stats(st), "counts": _counts(counts),
            "norms_whole": np.array([len(norms_whole)]), "norms": np.array(norms, np.float64),
            "coord": np.array([mesh.get_local_rank(0), mesh.get_local_rank(1)]), **grads}


def _counts(counts):
    return np.array([counts.get(k, 0) for k in COUNT_SITES], np.int64)


COUNT_SITES = ("grad", "norm", "param_vjp", "stats", "model", "all_gather", "clip")


def case_grad_auto(rank, world, inputs):
    return _default_grad(inputs, SolverConfig())


def case_grad_noseminorm(rank, world, inputs):
    return _default_grad(inputs, SolverConfig(adjoint_seminorm=False))


def case_grad_noseminorm22(rank, world, inputs):
    """As above on data 2 x model 2: the model ranks replicate the step."""
    return _default_grad(inputs, SolverConfig(adjoint_seminorm=False), model=2)


def _tp_step(inputs, fused, layout="batch_first"):
    mesh = make_mesh(data=2, model=2, device="cpu")
    cfg = tcnf.ICNFConfig(nvariables=2, solver=FAST, fused=fused, layout=layout)
    icnf = tcnf.ICNF(cfg, MLP((cfg.n_in, 32, 32, cfg.n_out)))
    whole = params_from_jax(unpack(inputs, "tp.p"))
    params = {k: v.requires_grad_() for k, v in shard_mlp_params(mesh, whole).items()}
    split = params["layers.0.weight"].shape[0]
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = shard_train_step(lambda p, g, xs, ys: (tcnf.loss(icnf, Mode.TRAIN, xs, p, g),), mesh,
                            tensor_parallel=True)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["tp.x"]))
    with draws(inputs["tp.eps"], inputs["tp.t1"]):
        (loss,) = step(params, opt, torch.Generator().manual_seed(0), xl, None)
    kept = params["layers.0.weight"].shape[0]
    gathered = pmesh.gather_mlp_params(mesh, params)
    return {"loss": loss.numpy(), "split": np.array([split, kept]),
            "counts": _counts(step.counts), **_np_params(gathered)}


def case_tp_step(rank, world, inputs):
    return _tp_step(inputs, fused=False)


def case_tp_fused(rank, world, inputs):
    return _tp_step(inputs, fused=True)


def case_feature_first(rank, world, inputs):
    """``layout="feature_first"``, each rank transposing its own rows: the
    data-parallel step of case_train_step (``dp.``) and the tensor-parallel
    one of case_tp_step (``tp.``)."""
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=FAST, layout="feature_first")
    params = _params(inputs, "train.p")
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    step = shard_train_step(lambda p, g, xs, ys: (tcnf.loss(icnf, Mode.TRAIN, xs, p, g),), mesh)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["train.x"]))
    with draws(inputs["train.eps"], inputs["train.t1"]):
        (loss,) = step(params, opt, torch.Generator().manual_seed(0), xl, None)
    out = {"dp.loss": loss.numpy(), **{f"dp.{k}": v for k, v in _np_params(params).items()}}
    out.update({f"tp.{k}": v for k, v in _tp_step(inputs, False, "feature_first").items()})
    return out


def _tp_model(inputs, **kw):
    """The h = 32 net of the tensor-parallel cases on data 2 x model 2, with
    ``tp.p``'s params split: ``(mesh, icnf, params)``."""
    mesh = make_mesh(data=2, model=2, device="cpu")
    cfg = tcnf.ICNFConfig(nvariables=2, **kw)
    icnf = tcnf.ICNF(cfg, MLP((cfg.n_in, 32, 32, cfg.n_out)))
    whole = params_from_jax(unpack(inputs, "tp.p"))
    return mesh, icnf, {k: v.requires_grad_() for k, v in shard_mlp_params(mesh, whole).items()}


def _gathered_grads(mesh, params):
    grads = pmesh.gather_mlp_params(mesh, {k: p.grad for k, p in params.items()})
    return {f"g.{k}": v.numpy() for k, v in grads.items()}


def case_tp_probe(rank, world, inputs):
    """Two probes split over ``model`` with the MLP split over it too: the
    gradients (an optimizer that does not move the params), then one Adam
    step."""
    mesh, icnf, params = _tp_model(inputs, nprobes=2, probe_axis="model", solver=FAST)
    step = shard_train_step(lambda p, g, xs, ys: (tcnf.loss(icnf, Mode.TRAIN, xs, p, g),), mesh,
                            tensor_parallel=True)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["tp.x"]))
    with draws(inputs["tpp.eps"], inputs["tp.t1"]):
        step(params, torch.optim.SGD(list(params.values()), lr=0.0),
             torch.Generator().manual_seed(0), xl, None)
        grads = _gathered_grads(mesh, params)
        (loss,) = step(params, torch.optim.Adam(list(params.values()), lr=1e-3),
                       torch.Generator().manual_seed(0), xl, None)
    return {"loss": loss.numpy(), "counts": _counts(step.counts), **grads,
            **_np_params(pmesh.gather_mlp_params(mesh, params))}


def case_tp_sweep(rank, world, inputs):
    """TEST inference with the exact sweep split over ``model`` on the split
    params of a net the analytic trace does not take (``from_torch``)."""
    solver = SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4)
    mesh, icnf, params = _tp_model(inputs, sweep_axis="model", exact_chunk=2, solver=solver)
    net = tcnf.from_torch(icnf.net, icnf.net.n_in, icnf.net.n_out)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["tp.x"]))
    with pmesh.use_mesh(mesh, tensor_parallel=True) as ctx, torch.no_grad():
        lp, _augs, st = tcnf.inference(tcnf.ICNF(icnf.config, net), Mode.TEST, xl, params)
    return {"lp": lp.numpy(), "stats": _stats(st), "counts": _counts(ctx.counts),
            "coord": np.array([mesh.get_local_rank(0), mesh.get_local_rank(1)])}


def _tp_noseminorm(inputs, fused):
    """The default stack without the seminorm under tensor parallelism: the
    gradients of one step, its stats and collectives, and its error norms."""
    mesh, icnf, params = _tp_model(inputs, fused=fused,
                                   solver=SolverConfig(adjoint_seminorm=False))
    with draws(inputs["grad.eps"], inputs["grad.t1"]), norms_of([]) as norms:
        loss, st, counts = _grad_step(icnf, mesh, params, inputs["grad.x"],
                                      tensor_parallel=True)
    return {"loss": loss.numpy(), "stats": _stats(st), "counts": _counts(counts),
            "norms": np.array(norms, np.float64), **_gathered_grads(mesh, params),
            "coord": np.array([mesh.get_local_rank(0), mesh.get_local_rank(1)])}


def case_tp_noseminorm(rank, world, inputs):
    return _tp_noseminorm(inputs, fused=False)


def case_tp_noseminorm_fused(rank, world, inputs):
    return _tp_noseminorm(inputs, fused=True)


def case_dryrun(rank, world, inputs):
    """``graft_entry.dryrun_multichip``'s rank body on the 4 ranks."""
    out = graft_entry.dryrun_rank(world, "cpu")
    return {"coord": np.array(out["coord"]), "loss": np.array(out["loss"]),
            "carry_loss": np.array(out["carry_loss"]), "lp": out["lp"].numpy()}


def case_probe_axis(rank, world, inputs):
    mesh = make_mesh(model=2, device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, nprobes=2, probe_axis="model",
                            solver=SolverConfig(method="rk4", gradient="backprop",
                                                fixed_steps=8))
    params = params_from_jax(unpack(inputs, "probe.p"))
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["probe.x"]))
    with draws(inputs["probe.eps"], inputs["probe.t1"]), pmesh.use_mesh(mesh) as ctx:
        lp = tcnf.inference(icnf, Mode.TRAIN, xl, params, torch.Generator().manual_seed(0))[0]
    return {"lp": lp.detach().numpy(), "counts": _counts(ctx.counts)}


def case_sweep_axis(rank, world, inputs):
    mesh = make_mesh(model=2, device="cpu")
    cfg = tcnf.ICNFConfig(nvariables=6, naugments=0, lambda_3=0.0, trace=TraceEstimator.EXACT,
                          sweep_axis="model", exact_chunk=0)
    net = MLP((cfg.n_in, 32, 32, 32, cfg.n_out))
    params = params_from_jax(unpack(inputs, "sweep.p"))
    with pmesh.use_mesh(mesh) as ctx:
        du = make_augmented_dynamics(cfg, net, Mode.TEST)(
            0.3, torch.from_numpy(inputs["sweep.u"]), {"params": params})
    return {"du": du.detach().numpy(), "counts": _counts(ctx.counts)}


def case_estimator(rank, world, inputs):
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=1, solver=FAST)
    x = inputs["est.x"]
    p0 = params_from_jax(unpack(inputs, "est.p"))
    sharded = tcnf.ICNFModel(icnf, batchsize=64, epochs=2, mesh=mesh, log_every=1).fit(
        x, params=p0)
    plain = tcnf.ICNFModel(icnf, batchsize=64, epochs=2, log_every=1, device="cpu").fit(
        x, params=p0)
    return {"hist": np.array(sharded.history), "hist_plain": np.array(plain.history),
            "score": np.array(tcnf.ICNFModel(icnf, mesh=mesh).score(x, sharded.params)),
            "score_plain": np.array(tcnf.ICNFModel(icnf, device="cpu").score(
                x, sharded.params)),
            **_np_params(sharded.params),
            **{"plain." + k: v for k, v in _np_params(plain.params).items()}}


def case_carry(rank, world, inputs):
    """``dt0="carry"`` with a mesh (the default stack's 3 steps): every rank
    carries the same start, and the fit is one process's."""
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(dt0="carry"))
    x, p0 = inputs["carry.x"], params_from_jax(unpack(inputs, "carry.p"))
    fits = [tcnf.ICNFModel(icnf, batchsize=64, epochs=1, log_every=1, **kw).fit(x, params=p0)
            for kw in (dict(mesh=mesh), dict(device="cpu"))]
    last = lambda r: np.array([r.stats[k] for k in ("nfe", "naccept", "nreject", "dt_final")])
    return {"hist": np.array(fits[0].history), "hist_plain": np.array(fits[1].history),
            "last": last(fits[0]), "last_plain": last(fits[1]), **_np_params(fits[0].params),
            **{"plain." + k: v for k, v in _np_params(fits[1].params).items()}}


def case_inventory(rank, world, inputs):
    """One step of the adaptive-adjoint fit: its collectives by site."""
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(method="dopri5", rtol=1e-3,
                                                              atol=1e-3, gradient="adjoint"))
    model = tcnf.ICNFModel(icnf, mesh=mesh, batchsize=0, epochs=1)
    params = _params(inputs, "inv.p")
    step = model._make_step(False)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["inv.x"]))
    opt = model.optimizer(list(params.values()))
    loss, st = step(params, opt, torch.Generator().manual_seed(2), xl, None)
    return {"counts": _counts(step.counts), "stats": _stats(st), "loss": loss.numpy()}


def case_fused_adaptive(rank, world, inputs):
    """K5/K6's route (their plain twins here) on 128 rows a rank against one
    process on all the rows."""
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True)
    x = inputs["fa.x"]
    params = _params(inputs, "fa.p")
    with draws(inputs["fa.eps"], inputs["fa.t1"]):
        loss, st, counts = _grad_step(icnf, mesh, params, x)
        whole = _params(inputs, "fa.p")
        l1, st1 = tcnf.loss_with_stats(icnf, Mode.TRAIN, torch.from_numpy(x), whole,
                                       torch.Generator().manual_seed(0))
        l1.backward()
    return {"loss": loss.numpy(), "loss1": l1.detach().numpy(), "stats": _stats(st),
            "stats1": _stats(st1), "fused": np.array([torch.is_tensor(st.nfe)]),
            "counts": _counts(counts),
            **{f"g.{k}": p.grad.numpy() for k, p in params.items()},
            **{f"g1.{k}": p.grad.numpy() for k, p in whole.items()}}


def case_fused_adaptive_partial(rank, world, inputs):
    """``fused_adaptive=True`` on 64 rows a rank (half a control group): the
    step refuses rather than leave the kernels for the unfused loop."""
    mesh = make_mesh(device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True)
    x = inputs["fa.x"][:64 * world]
    with draws(inputs["fa.eps"], inputs["fa.t1"]):
        try:
            _grad_step(icnf, mesh, _params(inputs, "fa.p"), x)
        except ValueError as e:
            return {"raised": np.array(str(e))}
    return {"raised": np.array("")}


def case_roundtrip(rank, world, inputs):
    mesh = make_mesh(data=2, model=2, device="cpu")
    layers = unpack(inputs, "tp.p")
    split = shard_mlp_params(mesh, params_from_jax(layers))
    back = params_to_jax(pmesh.gather_mlp_params(mesh, split))
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(layers, back) for k in ("w", "b"))
    shapes = np.array([split["layers.0.weight"].shape[0], split["layers.0.bias"].shape[0],
                       split["layers.1.weight"].shape[1], split["layers.2.weight"].shape[1]])
    return {"same": np.array([same]), "shapes": shapes}


def _export_mesh(inputs, data, model, solver):
    """This rank's ``export_logpdf(mesh=)`` program on a ``data x model``
    mesh, served its rows of ``exp.x`` (the counts too), then saved and
    loaded with the mesh: ``(results, mesh)``."""
    mesh = make_mesh(data=data, model=model, device="cpu")
    icnf = tcnf.ICNF.create(nvariables=2, solver=solver)
    art = ex._export_logpdf(icnf, params_from_jax(unpack(inputs, "exp.p")), mesh=mesh)
    xl, _ = shard_batch_arrays(mesh, torch.from_numpy(inputs["exp.x"]))
    lp, nfe, nacc, nrej = art.call(xl)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "logpdf.pt2")
        ex.save_artifact(path, art)
        reloaded = ex.load_artifact(path, mesh)
        same = torch.equal(reloaded.call(xl)[0], lp)
        try:
            ex.load_artifact(path)
            unchecked = True
        except ValueError:
            unchecked = False
    return {"lp": lp.numpy(), "stats": np.array([int(nfe), int(nacc), int(nrej)]),
            "coord": np.array([mesh.get_local_rank(0), mesh.get_local_rank(1)]),
            "mesh": np.array(art.mesh[0]), "reloaded_same": np.array([same]),
            "loads_without_mesh": np.array([unchecked])}


def case_export_abm(rank, world, inputs):
    return _export_mesh(inputs, 2, world // 2, SolverConfig(method="abm", rtol=1e-4,
                                                              atol=1e-4, gradient="quadrature"))


def case_export_dopri5(rank, world, inputs):
    return _export_mesh(inputs, 2, world // 2, SolverConfig(method="dopri5", rtol=1e-4,
                                                              atol=1e-4))


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(rank, world, store, work, cases):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        inputs = dict(np.load(os.path.join(work, "inputs.npz")))
        for name in cases:
            out = CASES[name](rank, world, inputs)
            np.savez(os.path.join(work, f"{name}_r{rank}.npz"), **out)
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(work, f"error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world, cases, work, join_s):
    """Run ``cases`` in ``world`` gloo ranks (``spawn``ed processes, one
    ``file://`` store under ``work``, each joined within ``join_s``
    seconds); ``{case: [rank 0's results, ...]}``.  A hung rank is killed,
    and any rank's failure fails the call with its traceback."""
    ctx = mp.get_context("spawn")
    store = os.path.join(work, f"store{world}")
    procs = [ctx.Process(target=main, args=(r, world, store, work, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
              if f.startswith("error_r")]
    assert not hung and not errors and all(p.exitcode == 0 for p in procs), (
        f"ranks {hung} hung past {join_s} s; exit codes "
        f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return {c: [dict(np.load(os.path.join(work, f"{c}_r{r}.npz"))) for r in range(world)]
            for c in cases}
