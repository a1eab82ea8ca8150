"""The port's entry points: the counterpart of the repo's ``__graft_entry__.py``.

``entry(device=None)``
    ``(fn, example_args)``: the flagship's TRAIN loss (2-D RNODE, Hutchinson
    VJP trace, rk4-32 with backprop, the reference's benchmark
    configuration) on 256 points, ``fn(params, xs, generator) -> loss``.
``dryrun_multichip(n_devices, device=None)``
    ``n_devices`` ranks, spawned, on a ``data x model`` mesh (``model = 2``
    at 4 or more ranks, an even number), each running :func:`dryrun_rank`:
    one Adam step of the flagship with a 2-probe ensemble split over
    ``model`` and the MLP split over it too (tensor parallelism), one epoch
    of the carried-start dopri5 fit with ``ICNFModel(mesh=)``, and TEST
    inference with the exact sweep split over ``model`` on the split params.
    On the card the ranks run on NCCL when there are ``n_devices`` cards,
    else on gloo sharing the cards there are; ``device="cpu"`` runs them on
    gloo on the CPU.

Both run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import ICNF, ICNFModel, Mode, SolverConfig, inference, loss
from .config import resolve_device
from .models.nets import from_torch
from .parallel import make_mesh, shard_batch_arrays, shard_mlp_params, shard_train_step
from .parallel import mesh as pmesh

__all__ = ["entry", "dryrun_multichip", "dryrun_rank"]

FLAGSHIP_SOLVER = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)
# how long the spawned ranks of dryrun_multichip may take, their start included
JOIN_S = 600


def entry(device=None):
    """``(fn, (params, xs, generator))`` with ``fn(params, xs, generator)``
    the flagship's TRAIN loss: params from seed 0, 256 points ``0.5 *
    N(0, I)`` from seed 1 (drawn on the CPU), the draws from seed 2 on
    ``device``."""
    device = resolve_device(device)
    icnf = ICNF.create(nvariables=2, solver=FLAGSHIP_SOLVER)
    params = icnf.init(torch.Generator().manual_seed(0), device=device)
    xs = (0.5 * torch.randn((256, 2), generator=torch.Generator().manual_seed(1))).to(device)
    generator = torch.Generator(device=device).manual_seed(2)

    def fn(params, xs, generator):
        return loss(icnf, Mode.TRAIN, xs, params, generator)

    return fn, (params, xs, generator)


def _finite(name: str, t: torch.Tensor) -> None:
    if not bool(torch.all(torch.isfinite(t))):
        raise RuntimeError(f"multichip dryrun: {name} is not finite")


def dryrun_rank(n_devices: int, device=None) -> dict:
    """The body of a rank of :func:`dryrun_multichip`, in a process group of
    ``n_devices`` ranks that is already set up.  Returns this rank's mesh
    coordinate, the step's loss, the carried fit's final loss and the TEST
    log-densities of its rows (``lp``; None without a model axis)."""
    device = resolve_device(device)
    # data x model: a model axis where there are enough ranks, so that the
    # tensor-parallel and the probe- and sweep-sharding paths run too
    model = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    mesh = make_mesh(devices=range(n_devices), model=model, device=device)
    dev = pmesh.mesh_device(mesh)

    icnf = ICNF.create(nvariables=2, nprobes=2 if model > 1 else 1,
                       probe_axis="model" if model > 1 else None, solver=FLAGSHIP_SOLVER)
    params = shard_mlp_params(mesh, icnf.init(torch.Generator().manual_seed(0), device=dev))
    params = {k: v.requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    batch = max(8, n_devices) * 2
    xs = 0.5 * torch.randn((batch, 2), generator=torch.Generator().manual_seed(1))
    step = shard_train_step(lambda p, g, x, y: (loss(icnf, Mode.TRAIN, x, p, g),), mesh,
                            tensor_parallel=model > 1)
    xl, _ = shard_batch_arrays(mesh, xs)
    (loss_val,) = step(params, opt, torch.Generator(device=dev).manual_seed(2), xl, None)
    _finite("the tensor-parallel step's loss", loss_val)

    # the carried start of the adaptive solve, on the same mesh (the model
    # ranks replicate the fit)
    icnf_carry = ICNF.create(nvariables=2, solver=SolverConfig(
        method="dopri5", rtol=1e-3, atol=1e-3, gradient="adjoint", dt0="carry"))
    res = ICNFModel(icnf_carry, mesh=mesh, batchsize=batch, epochs=1,
                    generator=torch.Generator(device=dev).manual_seed(3)).fit(xs)
    carry_loss = torch.tensor(res.stats["final_loss"])
    _finite("the carried fit's loss", carry_loss)

    lp = None
    if model > 1:
        # the exact sweep split over the model axis, on the split params; a
        # net the analytic MLP trace does not take (from_torch) sweeps
        cfg_sweep = dataclasses.replace(
            icnf.config, sweep_axis="model", exact_chunk=2, nprobes=1, probe_axis=None,
            solver=SolverConfig(method="dopri5", rtol=1e-3, atol=1e-3))
        icnf_sweep = ICNF(cfg_sweep, from_torch(icnf.net, icnf.net.n_in, icnf.net.n_out))
        with pmesh.use_mesh(mesh, tensor_parallel=True), torch.no_grad():
            lp = inference(icnf_sweep, Mode.TEST, xl, params)[0]
        _finite("the sharded exact sweep's log-density", lp)
    return {"coord": (mesh.get_local_rank(0), mesh.get_local_rank(1)),
            "loss": float(loss_val), "carry_loss": float(carry_loss),
            "lp": None if lp is None else lp.cpu()}


def _rank_main(rank, world, store, work, device_type, backend):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=JOIN_S))
        out = dryrun_rank(world, device_type)
        torch.save(out, os.path.join(work, f"r{rank}.pt"))
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(work, f"error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks that each run :func:`dryrun_rank`, and join
    them.  Returns ``{"backend", "seconds", "ranks": [each rank's results]}``;
    raises with the ranks' tracebacks where one fails or hangs."""
    device = resolve_device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n_devices else "gloo"
        where = ("one card a rank" if backend == "nccl"
                 else f"gloo ranks sharing {cards} card(s)")
    else:
        backend, where = "gloo", "the CPU"
    print(f"[dryrun_multichip] {n_devices} ranks on {backend}: {where}", flush=True)
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.get_context("spawn")
        store = os.path.abspath(os.path.join(work, "store"))
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_devices, store, work, device.type, backend))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, JOIN_S - (time.perf_counter() - started)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
                  if f.startswith("error_r")]
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"multichip dryrun: ranks {hung} hung; exit codes "
                               f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        ranks = [torch.load(os.path.join(work, f"r{r}.pt")) for r in range(n_devices)]
    return {"backend": backend, "seconds": time.perf_counter() - started, "ranks": ranks}
