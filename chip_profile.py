"""Device-time profile of the PyTorch port on one NVIDIA GPU: the train steps
and serving calls of PERF.md section 5.

    python3 chip_profile.py [row ...]
    python3 chip_profile.py k2-grid
    python3 chip_profile.py k2-wide
    python3 chip_profile.py k2-phases
    python3 chip_profile.py k1-wide
    python3 chip_profile.py k1-phases
    python3 chip_profile.py solve-wide
    python3 chip_profile.py wide-f32
    python3 chip_profile.py widths
    python3 chip_profile.py fwd-widths
    python3 chip_profile.py adaptive-widths
    python3 chip_profile.py adaptive-wide
    python3 chip_profile.py sass
    python3 chip_profile.py nccl

Each row runs the flagship 2-D RNODE (or its FFJORD form) at 65,536 samples,
or ``chip_smoke.py``'s image model (d = 784, h = 1024) at batch 256 (its
fit steps, and its dopri5 eval twin's TEST log-density, exported by
``utils.export`` and eager), or its digits-shaped model (d = 64, h = 256,
fit steps through K3 + K4, without the random shifts), under ``torch.profiler``: 2 warm-up steps or
calls, then 3 profiled ones.  Per row it prints the device kernels per step
(and, where unfused adaptive solves run, per trial step of them, forward
and backward solves counted together), the summed device time of those
kernels ("busy"), the host wall time of the profiled steps (inflated by the
profiler), the idle share ``1 - busy / wall``, the device time of each of
K1-K6 by its kernels' names and the top kernels, and writes every row to
``chiprun_out/chip_profile.json``.  With no arguments it runs every row.
Every run keeps the card busy for 10 s before its first measurement.  The
kernels build at first use, as in ``chip_smoke.py``.  K6 shows as its two
kernels, ``adaptive_replay`` and ``walk_rows`` (above h = 32 as one,
``adaptive_bwd_cluster``, or ``adaptive_bwd`` on the tiled path), K4 as ``solve_traj_rows`` and
``fused_solve_rk4_bwd_rows``.

``adaptive-wide`` times K5 and K6 above their row paths (h = 33 ... 128
at 6 -> h -> h -> 5, B = 8,192 and 65,536, and the JAX package's adaptive
band, 42 -> 128 -> 128 -> 41 at B = 16,384 and 65,536) on the cluster path
with 2 and with 4 CTAs a group and on the tiled path, in turns in one
process: the measurement behind the cluster plan's taking the cluster path at
every width it fits, and its choice of the cluster size (``cluster_plan`` in
``csrc/cluster_adaptive.cuh``).

``k2-grid`` is the measurement behind K2's launch shape on its row path:
it builds the kernels a second time with ``-DCNF_K2_ONE_BLOCK_A_TILE`` (a
block for every 64-row tile instead of at most 264 blocks that take tiles in
turn) and times K2 in both builds, in turns, at the flagship and the FFJORD
widths.  ``k2-wide`` times K2 above its row path (h = 32 ... 1024) with the path
each width takes: from two checkouts in one call, the measurement behind the
width where K2's wide path takes over; ``k2-phases`` lists one wide-path
call's kernels with their device times, beside ``torch.matmul`` of one of
its products.  ``k1-wide`` and ``k1-phases`` do the same for K1 (h = 33
... 1024, the batches of ``k2-wide``; beside K1's wide launches,
``torch.matmul`` of each of its six products); both wide modes print a
digest of the outputs' bits, so that two checkouts show whether they
agree bit for bit.  ``solve-wide`` does the same for K3 and K4 (h = 24, 33
... 256, B = 256, 8,192 and 65,536, 4 steps): the measurement behind the
width where their wide paths take over.  ``wide-f32`` times the fp32 product
core of the wide paths (``csrc/wide_gemm.cuh``) at the d43 benchmark cell's
shapes (88 -> 352 -> 352 -> 87, B = 8,192): one product of each kind on each
tile, beside ``torch.matmul``, and K3 and K4 whole with K4's device time
split into its trajectory, the walk's recompute, its stage backwards, their
merges and the slices' sums.  ``widths`` times K2 and K6 at every
hidden width of the row path and
just past it (h = 8 ... 33), by the device time of their kernels: the
measurement behind the rule that h <= 32 takes that path; beside K6 it
counts K5's steps, which K6 replays.  ``fwd-widths`` does the same for the
forward kernels K1 and K3 (h = 8, 12, 16, 24, 32, fp32 and bf16), and
``adaptive-widths`` for K5 alone (h = 8 ... 33 and 128, two tolerances, with
its cost a stage evaluation and its fixed cost) and K6's replay.  Run from
two checkouts in one call, the width modes compare two commits width by
width, and so do the rows.  ``sass`` reads the instruction mix (``cuobjdump
-sass``), the registers, local memory and resident blocks an SM
(``cuobjdump -res-usage``) and the spills (the build's ptxas lines) of the
row kernels of K1, K3, K5 and K6's replay in the built library.  ``nccl``
needs a machine with several cards and takes them all: the parallel layer
on NCCL, one rank a card.  It fits ``chip_smoke.py``'s digits-shaped model
with ``mesh=`` at global batches 256 and 1,024 (the rows split over the
ranks) and takes one step of the flagship's default adaptive stack on
65,536 rows, each against one process on card 0 at the same batch: the
StepTimer rates (and the default stack's step by the host clock), the
NCCL all-reduce's device ms a step, the collectives a step, and the
params against one process's.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

BATCH = 65_536
WARMUP, ACTIVE = 2, 3


# each kernel's launches by name (regular expressions), row, tiled and wide
# paths (the reduction of the backwards' weight-gradient partial sums, shared
# by K2, K4 and K6, in none).  The wide paths of K1-K4 share the product core
# and the conversion kernel: their products are told apart by the epilogue
# type, the conversion (and the bias sums of K2 and K4) by its template
# argument (a checkout from before K1's wide path has K2's alone,
# untemplated; one from before K3's and K4's, K2's bias sums untemplated).
KERNELS = {"K1": (r"\bfused_dynamics_fwd_(rows|kernel)[<(]", r"\bwide_products<.*\bFwdEpi",
                  r"\bwide_to_bf16<1>", r"\bwide_fwd_norms\("),
           "K2": (r"\bfused_dynamics_bwd_(rows|kernel)[<(]", r"\bwide_products<.*\bBwdEpi",
                  r"\bwide_to_bf16(<2>)?\(",
                  r"\bwide_(merge|add_slices|bias_sums|bias_add)(<2>)?\("),
           "K3": (r"\bfused_solve_rk4_(rows|kernel)[<(]", r"\bwide_products<.*SolveFwdEpi",
                  r"\bwide_to_bf16<3>", r"\bsolve_inputs<3,", r"\bsolve_rk4_stage<"),
           "K4": (r"\b(solve_traj_rows|fused_solve_rk4_bwd_rows|fused_solve_rk4_bwd_kernel)[<(]",
                  r"\bwide_products<.*SolveBwdEpi", r"\bwide_to_bf16<4>",
                  r"\bwide_bias_(sums|add)<4>", r"\bsolve_inputs<4,", r"\bsolve_load_x<",
                  r"\bsolve_(merge|add_slices)\("),
           "K5": (r"\badaptive_fwd_(rows|tiled|cluster)[<(]",),
           "K6": (r"\b(adaptive_replay|adaptive_replay_tiled|walk_rows|adaptive_bwd|"
                  r"adaptive_bwd_cluster)[<(]",)}


def is_kernel(name, k):
    return any(re.search(p, name) for p in KERNELS[k])


def summarize(prof, wall_s):
    events = prof.key_averages()
    # device events that carry a host op's name are annotations (ProfilerStep*,
    # Optimizer.step#...) spanning kernels, not kernels
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ACTIVE
    wall_ms = wall_s * 1e3 / ACTIVE
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    per_step = {k: sum(e.self_device_time_total for e in kernels if is_kernel(e.key, k))
                / 1e3 / ACTIVE for k in KERNELS}
    return dict(kernels_per_step=sum(e.count for e in kernels) / ACTIVE, busy_ms=busy_ms,
                wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms, kernel_ms=per_step,
                top=[(e.key[:70], e.self_device_time_total / 1e3 / ACTIVE, e.count / ACTIVE)
                     for e in top])


TRIALS = [0]  # trial steps of the unfused adaptive loops (dopri5/tsit5 and abm) so far


def count_trials():
    """Count the trial steps of every unfused adaptive solve (forward and
    backward) from here on."""
    from continuousnormalizingflows_tpu_torch.ops import ode

    for name in ("_adaptive_loop", "_abm_loop"):
        loop = getattr(ode, name)

        def counted(*a, _loop=loop, **k):
            run = _loop(*a, **k)
            TRIALS[0] += run.steps
            return run

        setattr(ode, name, counted)


def profiled(step):
    """``step(callback)`` runs WARMUP + ACTIVE steps, calling ``callback``
    after each."""
    marks, trials = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=WARMUP, active=ACTIVE, repeat=1)) as prof:
        def callback(*_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            trials.append(TRIALS[0])
            prof.step()

        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        trials.append(TRIALS[0])
        step(callback)
    out = summarize(prof, marks[WARMUP + ACTIVE] - marks[WARMUP])
    n = (trials[WARMUP + ACTIVE] - trials[WARMUP]) / ACTIVE
    out["trial_steps_per_step"] = n
    out["kernels_per_trial_step"] = out["kernels_per_step"] / n if n else None
    return out


def fit_row(dev, data, icnf=None, batch=BATCH, **create):
    """A fit's steps at ``batch``: the flagship built from ``create``, or
    ``icnf``."""
    import continuousnormalizingflows_tpu_torch as cnf

    icnf = icnf or cnf.ICNF.create(nvariables=2, **create)
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    steps_per_epoch = data.shape[0] // batch
    epochs = -(-(WARMUP + ACTIVE) // steps_per_epoch)

    def step(callback):
        cnf.ICNFModel(icnf, batchsize=batch, epochs=epochs, log_every=1, callback=callback,
                      device=dev, generator=torch.Generator(device=dev).manual_seed(7),
                      ).fit(data, params=params)

    return lambda: profiled(step)


def call_row(dev, x, mode, icnf=None, **create):
    import continuousnormalizingflows_tpu_torch as cnf

    icnf = icnf or cnf.ICNF.create(nvariables=2, **create)
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)

    def step(callback):
        with torch.no_grad():
            for i in range(WARMUP + ACTIVE):
                gen = torch.Generator(device=dev).manual_seed(2 + i)
                cnf.ICNFDist(icnf, params, mode, gen).logpdf(x)
                callback()

    return lambda: profiled(step)


def export_row(dev, x, icnf):
    """Calls of the exported TEST log-density (``utils.export``) of ``icnf``."""
    from continuousnormalizingflows_tpu_torch.utils.export import export_logpdf

    def step(callback):
        for _ in range(WARMUP + ACTIVE):
            art.call(x)
            callback()

    def row():
        nonlocal art
        art = export_logpdf(icnf, icnf.init(torch.Generator().manual_seed(0), device=dev),
                            device=dev)
        return profiled(step)

    art = None
    return row


def rows(dev):
    from chip_smoke import (DIGITS_HIDDEN, DIGITS_SIDE, IMAGE_BATCH, IMAGE_HIDDEN, IMAGE_SIDE,
                            image_model)
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import (gaussian_mixture,
                                                                     smooth_image_mixture)

    data = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), 4 * BATCH)
    x = data[:BATCH]
    rk4 = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)
    ffjord = dict(naugments=0, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0)
    # bench.py's abm + quadrature row: the reference's VCABM with QuadratureAdjoint
    abm = SolverConfig(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature")
    # chip_smoke.py's [image] model (d = 784, h = 1024) at batch 256, and its
    # dopri5 eval twin on 256 points
    images = smooth_image_mixture(torch.Generator(device=dev).manual_seed(1),
                                  (WARMUP + ACTIVE) * IMAGE_BATCH, IMAGE_SIDE)
    image = lambda **kw: image_model(IMAGE_SIDE, IMAGE_HIDDEN, **kw)
    # and the digits-shaped model (d = 64, h = 256) at batch 256, through K3 + K4
    digits = smooth_image_mixture(torch.Generator(device=dev).manual_seed(1),
                                  (WARMUP + ACTIVE) * IMAGE_BATCH, DIGITS_SIDE)
    return {
        "rk4 flagship, fused": fit_row(dev, data, solver=rk4, fused=True),
        "rk4 FFJORD form, fused": fit_row(dev, data, solver=rk4, fused=True, **ffjord),
        "rk4 flagship, fused=False": fit_row(dev, data, solver=rk4),
        "default stack (dopri5, backsolve, auto), unfused": fit_row(dev, data),
        "default stack, fused=True (K1 + K2)": fit_row(dev, data, fused=True),
        "default stack, dt0=carry": fit_row(dev, data, solver=SolverConfig(dt0="carry")),
        "default stack, quadrature adjoint": fit_row(
            dev, data, solver=SolverConfig(gradient="quadrature")),
        "fused_adaptive=True (K5 + K6)": fit_row(dev, data, fused=True, fused_adaptive=True),
        "abm + quadrature, unfused": fit_row(dev, data, solver=abm),
        "abm + quadrature, fused=True (K1 + K2)": fit_row(dev, data, solver=abm, fused=True),
        "serving rk4 TEST logpdf, fused": call_row(dev, x, Mode.TEST, solver=rk4, fused=True),
        "serving rk4 TRAIN logpdf, fused (K3)": call_row(dev, x, Mode.TRAIN, solver=rk4,
                                                         fused=True),
        "serving default stack TEST logpdf": call_row(dev, x, Mode.TEST),
        "serving default stack TRAIN logpdf": call_row(dev, x, Mode.TRAIN),
        "serving abm TEST logpdf": call_row(dev, x, Mode.TEST, solver=abm),
        "image fit step, fused (K1 + K2)": fit_row(dev, images, image(fused=True), IMAGE_BATCH),
        "image fit step, fused=False": fit_row(dev, images, image(), IMAGE_BATCH),
        "digits-shaped fit step, fused (K3 + K4)": fit_row(
            dev, digits, image_model(DIGITS_SIDE, DIGITS_HIDDEN, fused=True), IMAGE_BATCH),
        "image eval TEST logpdf, exported": export_row(dev, images[:IMAGE_BATCH],
                                                       image(eval_twin=True)),
        "image eval TEST logpdf, eager": call_row(dev, images[:IMAGE_BATCH], Mode.TEST,
                                                  image(eval_twin=True)),
    }


def device_ms(fn, names, reps=30, warmup=5):
    """Device time of one call of ``fn``: the summed time of the kernels whose
    name matches one of the regular expressions ``names``, over ``reps``
    profiled calls after 5 warm-up ones.  A CUDA-event time around a call
    would also hold the wrapper's host time wherever the card waits for it,
    as it does at these widths."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(re.search(n, e.key) for n in names))
    return total / 1e3 / reps


def digest(tensors) -> str:
    """A short hash of the tensors' bits: two checkouts that give the same
    bits print the same digest."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


K2_KERNELS = (*KERNELS["K2"], r"\breduce_partials[<(]")


def k2_path(plan) -> str:
    """The path of K2's plan; a checkout from before the wide path has no
    scratch field in its plan, so this reads the plan by position."""
    return "row" if plan[4] else "wide" if len(plan) > 5 and plan[5] else "tiled"
K6_KERNELS = (*KERNELS["K6"], r"\breduce_partials[<(]")


def stage_inputs(dev, n_in, h, nz, batch=BATCH):
    from continuousnormalizingflows_tpu_torch.models.nets import MLP

    params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, n_in), generator=g, device=dev)
    eps = torch.randn((batch, nz), generator=g, device=dev)
    cot = (torch.randn((batch, nz), generator=g, device=dev),
           torch.randn((batch, nz), generator=g, device=dev),
           *torch.randn((3, batch), generator=g, device=dev))
    return x, eps, params, nz, cot


def k2_grid(dev):
    """K2 on its row path, blocks that take tiles in turn (the package's
    build) against a block for every tile: device ms of K2's kernel and its
    reduction, the two builds in turns (a, b, b, a), twice."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp_bwd

    flags = {"tiles in turn": list(_build.NVCC_FLAGS),
             "a block a tile": [*_build.NVCC_FLAGS, "-DCNF_K2_ONE_BLOCK_A_TILE"]}

    def use(build):
        _build.NVCC_FLAGS[:] = flags[build]
        _build.kernels.cache_clear()
        _build.bwd_plan.cache_clear()
        _build.kernels()

    out = {}
    for shape, n_in, h, nz in (("flagship", 6, 24, 5), ("FFJORD widths", 3, 12, 2),
                               ("h = 16", 6, 16, 5), ("h = 8", 6, 8, 5)):
        args = stage_inputs(dev, n_in, h, nz)
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            fn = lambda: fused_dynamics_vjp_bwd(*args, cdt)
            times, grids, results = {k: [] for k in flags}, {}, {}
            for build in ("tiles in turn", "a block a tile", "a block a tile", "tiles in turn") * 2:
                use(build)
                grids[build] = _build.bwd_plan(n_in, h, nz, nz, 0, BATCH)[2]
                results[build] = fn()
                times[build].append(device_ms(fn, K2_KERNELS))
            a, b = results.values()
            if not all(torch.equal(p, q) for p, q in zip((a[0], a[1]), (b[0], b[1]))):
                raise SystemExit(f"k2-grid {shape} {prec}: the two builds differ in xbar or epsbar")
            row = out[f"{shape} {prec}"] = {
                k: dict(grid=grids[k], ms=sorted(v)[len(v) // 2], min=min(v), max=max(v))
                for k, v in times.items()}
            print(f"k2-grid {shape} {prec} B={BATCH}, device ms: " + "; ".join(
                f"{k} (grid {r['grid']}) {r['ms']:.4f} (min {r['min']:.4f}, max {r['max']:.4f})"
                for k, r in row.items()), flush=True)
    use("tiles in turn")
    return out


def widths(dev):
    """K2 and K6 over the hidden widths of the row path (and just past it) at
    batch 65,536, fp32 and (K2) bf16: device ms of each kernel's launches,
    with the path its plan names.  Run from two checkouts in one call, it
    compares their kernels width by width."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp_bwd

    out = {}
    for h in (8, 12, 16, 24, 32, 33):
        n_in, nz = (3, 2) if h == 12 else (6, 5)
        args = stage_inputs(dev, n_in, h, nz)
        plan = _build.bwd_plan(n_in, h, nz, nz, 0, BATCH)
        path = {"row": f"row, H = {plan[4]}", "wide": "wide",
                "tiled": f"tiled, {plan[0]} rows a tile"}[k2_path(plan)]
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            ms = sorted(device_ms(lambda: fused_dynamics_vjp_bwd(*args, cdt), K2_KERNELS)
                        for _ in range(3))
            out[f"K2 h={h} {prec}"] = dict(path=path, grid=plan[2], ms=ms[1], min=ms[0], max=ms[2])
            print(f"widths K2 {n_in}->{h}->{h}->{nz} {prec} B={BATCH} ({path}, grid {plan[2]}): "
                  f"device ms {ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f})", flush=True)
    scfg = (1e-4, 1e-4, 0.01, 0.9, 0.2, 10.0, 16_384)
    for h in (8, 16, 24, 32, 33):
        n_in, nz = 6, 5
        _x, eps, params, _nz, _cot = stage_inputs(dev, n_in, h, nz)
        g = torch.Generator(device=dev).manual_seed(2)
        u0 = torch.cat([0.5 * torch.randn((BATCH, nz), generator=g, device=dev),
                        torch.zeros((BATCH, 3), device=dev)], dim=-1)
        gbar = torch.randn((BATCH, nz + 3), generator=g, device=dev)
        span = (0.0, torch.tensor(1.05, device=dev))
        fn = lambda: fa.fused_solve_dopri5_bwd(u0, eps, None, params, span, nz, nz, scfg, 64, gbar)
        nacc = fn()[3]
        with torch.no_grad():  # K5's steps, which K6 replays: its work depends on them
            rows = fa.fused_solve_dopri5(u0, eps, None, params, span, nz, nz, scfg, 64)[1]
        steps = dict(nfe=int(rows[:, 0].sum()), nfe_max=int(rows[:, 0].max()),
                     accepted_total=int(rows[:, 1].sum()))
        plan = _build.adaptive_plan(n_in, h, nz, nz, nz + 3, 128)
        ms = sorted(device_ms(fn, K6_KERNELS, reps=5) for _ in range(3))
        out[f"K6 h={h}"] = dict(plan=list(plan), ms=ms[1], min=ms[0], max=ms[2],
                                accepted=[int(nacc.min()), int(nacc.max())], **steps)
        print(f"widths K6 {n_in}->{h}->{h}->{nz} fp32 B={BATCH} (plan {plan}; accepted steps "
              f"{int(nacc.min())}-{int(nacc.max())} a group; over all groups NFE {steps['nfe']}, "
              f"at most {steps['nfe_max']} a group, accepted {steps['accepted_total']}): device ms "
              f"{ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f})", flush=True)
    return out


# (h, n_in, nz, batch): widths past K2's row path at the flagship's input and
# output (6, 5) and three batches, then the tabular width, the digits-shaped
# and the image widths at the batches of their paths
K2_WIDE_SHAPES = (*((h, 6, 5, b) for h in (32, 48, 64, 96, 128) for b in (256, 8_192, 65_536)),
                  (176, 44, 43, 8_192), (256, 65, 64, 256), (1024, 785, 784, 256))


def peak_mb(dev, fn):
    """The device memory one call of ``fn`` adds to the peak, in MB (after a
    first call that builds the kernels)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


def k2_wide(dev):
    """K2 above the row path's widths (h = 32 ... 1024, each at the batch of
    its path), fp32 and bf16: device ms of every K2 kernel a call, with the
    path its plan names, the peak device memory a call adds and a digest of
    its outputs' bits.  Run from two checkouts in one call, it compares
    their K2 width by width: the measurement behind the wide path's least
    width (kWideMinH), and whether a change kept K2's bits."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp_bwd

    out = {}
    for h, n_in, nz, b in K2_WIDE_SHAPES:
        args = stage_inputs(dev, n_in, h, nz, b)
        plan = tuple(_build.bwd_plan(n_in, h, nz, nz, 0, b))
        path = k2_path(plan)
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            fn = lambda: fused_dynamics_vjp_bwd(*args, cdt)
            xbar, epsbar, wbars = fn()
            bits = digest([xbar, epsbar, *wbars])
            mb = peak_mb(dev, fn)
            reps = 5 if h == 1024 and path != "wide" else 20
            ms = sorted(device_ms(fn, K2_KERNELS, reps=reps) for _ in range(3))
            out[f"K2 h={h} {prec}"] = dict(path=path, plan=list(plan), batch=b, ms=ms[1],
                                           min=ms[0], max=ms[2], peak_mb=mb, digest=bits)
            print(f"k2-wide K2 {n_in}->{h}->{h}->{nz} {prec} B={b} ({path}, plan {plan}): "
                  f"device ms {ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f}), peak "
                  f"{mb:.1f} MB a call, bits {bits}", flush=True)
    return out


# (h, n_in, nz, batch): K2_WIDE_SHAPES with K1's first width past its row
# path (h = 33) beside h = 32
K1_WIDE_SHAPES = (*((33, 6, 5, b) for b in (256, 8_192, 65_536)), *K2_WIDE_SHAPES)


def k1_path(n_in, h, nz, b) -> str:
    """The path of K1's plan; a checkout from before K1's wide path has no
    ``fwd_plan``, and its K1 takes ``plan``'s row or tiled path."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    if hasattr(_build, "fwd_plan"):
        return _build.fwd_plan(n_in, h, nz, nz, b).path
    return "row" if _build.plan(n_in, h, nz, nz, 0)[2] else "tiled"


def k1_wide(dev):
    """K1 past its row path's widths (h = 32 ... 1024, each at the batches of
    K2's shapes), fp32 and bf16: device ms of every K1 kernel a call, with
    the path its plan names, the peak device memory a call adds and a digest
    of its outputs' bits.  Run from two checkouts in one call, it compares
    their K1 width by width: the measurement behind K1's kWideMinH."""
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp

    out = {}
    for h, n_in, nz, b in K1_WIDE_SHAPES:
        x, eps, params, _nz, _cot = stage_inputs(dev, n_in, h, nz, b)
        path = k1_path(n_in, h, nz, b)
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            fn = lambda: fused_dynamics_vjp(x, eps, params, nz, cdt)
            bits = digest(fn())
            mb = peak_mb(dev, fn)
            reps = 5 if h == 1024 and path != "wide" else 20
            ms = sorted(device_ms(fn, KERNELS["K1"], reps=reps) for _ in range(3))
            out[f"K1 h={h} {prec} B={b}"] = dict(path=path, batch=b, ms=ms[1], min=ms[0],
                                                 max=ms[2], peak_mb=mb, digest=bits)
            print(f"k1-wide K1 {n_in}->{h}->{h}->{nz} {prec} B={b} ({path}): device ms "
                  f"{ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f}), peak {mb:.1f} MB a call, "
                  f"bits {bits}", flush=True)
    return out


# (h, n_in, nz): the widths of solve-wide, the row path's flagship (h = 24),
# then from just past the row path (h = 33) to the digits-shaped fit's (65 ->
# 256 -> 256 -> 64); the net input is [z, t], the state nz + 3
SOLVE_WIDE_SHAPES = ((24, 6, 5), (33, 6, 5), (48, 6, 5), (64, 6, 5), (96, 6, 5), (128, 6, 5),
                     (176, 44, 43), (256, 65, 64))
SOLVE_WIDE_BATCHES = (256, 8_192, 65_536)
SOLVE_WIDE_STEPS = 4


def solve_path(n_in, h, nz, b, k) -> str:
    """The path of K3's or K4's plan; a checkout from before their wide paths
    has a K3 plan of (rows, staged, H)."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    if k == "K4":
        return _build.bwd_plan(n_in, h, nz, nz, nz + 3, b).path
    plan = _build.plan(n_in, h, nz, nz, nz + 3)
    return getattr(plan, "path", "row" if plan[2] else "tiled")


def solve_wide(dev):
    """K3 and K4 at the widths of SOLVE_WIDE_SHAPES and batches of
    SOLVE_WIDE_BATCHES, fp32 and bf16, SOLVE_WIDE_STEPS steps: device ms of
    every kernel of a call, with the path each plan names, the peak device
    memory a call adds and a digest of the outputs' bits.  Run from two
    checkouts in one call, it compares their K3 and K4 width by width: the
    measurement behind the wide solves' least width (kSolveWideMinH), and
    whether a change kept the bits of the paths it did not touch."""
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (fused_solve_rk4,
                                                                      fused_solve_rk4_bwd)

    out, steps = {}, SOLVE_WIDE_STEPS
    for h, n_in, nz in SOLVE_WIDE_SHAPES:
        for b in SOLVE_WIDE_BATCHES:
            _x, eps, params, _nz, _cot = stage_inputs(dev, n_in, h, nz, b)
            g = torch.Generator(device=dev).manual_seed(2)
            u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                            torch.zeros((b, 3), device=dev)], dim=-1)
            gbar = torch.randn((b, nz + 3), generator=g, device=dev)
            span = (0.0, torch.tensor(1.05, device=dev))
            for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
                calls = {
                    "K3": lambda: [fused_solve_rk4(u0, eps, None, params, span, nz, nz, steps,
                                                   cdt)],
                    "K4": lambda: [t for o in fused_solve_rk4_bwd(u0, eps, None, params, span,
                                                                  nz, nz, steps, gbar, cdt)
                                   for t in (o if isinstance(o, tuple) else (o,))]}
                for k, fn in calls.items():
                    path = solve_path(n_in, h, nz, b, k)
                    bits = digest(fn())
                    mb = peak_mb(dev, fn)
                    reps = 3 if b == 65_536 and path != "wide" else 10
                    ms = sorted(device_ms(fn, KERNELS[k], reps=reps) for _ in range(3))
                    out[f"{k} h={h} {prec} B={b}"] = dict(path=path, batch=b, steps=steps,
                                                          ms=ms[1], min=ms[0], max=ms[2],
                                                          peak_mb=mb, digest=bits)
                    print(f"solve-wide {k} {n_in}->{h}->{h}->{nz} {prec} B={b} steps={steps} "
                          f"({path}): device ms {ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f}), "
                          f"peak {mb:.1f} MB a call, bits {bits}", flush=True)
    return out


# wide-f32: the d43 cell's shapes, and the core's tiles by index (2: the
# first design's 64 x 32; -1: the tile rule's choice)
WIDE_F32_DIMS = dict(b=8_192, h=352, n_in=88, nz=87, steps=32)
WIDE_F32_TILES = {2: "64x32", 0: "128x96", 1: "64x96", -1: "rule"}


def wide_f32_products(dev):
    """(name, operands, M, N, K, kseg, slices) of each kind of the d43 chain's
    fp32 products, on random inputs."""
    b, h, n_in, nz = (WIDE_F32_DIMS[k] for k in ("b", "h", "n_in", "nz"))
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, hid, d, eb = r(b, n_in), r(b, h), r(b, h), r(b, nz)
    a1, a2, a3 = r(h, n_in), r(h, h), r(nz, h)

    def row(t, e):
        return (t, e, None, e, True)

    def col(t, e):
        return (t, e, None, e, False)

    wgrad = ((hid, h, d, h, False), (hid, h, d, h, False), h, h, 2 * b, b)
    return [("F2/B2 (N=352, K=352)", row(hid, b), row(a2, h), b, h, h, 1 << 30, 1),
            ("U1/Z1 (N=352, K=352, B by column)", row(d, b), col(a2, h), b, h, h, 1 << 30, 1),
            ("F1 (N=352, K=88)", row(x, b), row(a1, h), b, h, n_in, 1 << 30, 1),
            ("B1 (N=352, K=87, rows of 87)", row(eb, b), row(a1, h), b, h, nz, 1 << 30, 1),
            ("Y/kStep (N=87, K=352)", row(hid, b), row(a3, nz), b, nz, h, 1 << 30, 1),
            ("E/Vb (N=87, K=352, B by column)", row(d, b), col(a1, nz), b, nz, h, 1 << 30, 1),
            ("dA2 (352 x 352, K=16,384), 3 slices", *wgrad, 3),
            ("dA2 (352 x 352, K=16,384), 14 slices", *wgrad, 14)]


def wide_f32(dev):
    """The fp32 product core at the d43 cell's shapes: each product of
    wide_f32_products on each tile (WIDE_F32_TILES: the first design's 64 x
    32, the Hopper tiles, the rule's choice), device us by the profiler and
    TFLOP/s, each tile's bits against the first design's, beside
    ``torch.matmul`` of the same (M x K) @ (K x N) in fp32 (TF32 off; a
    yardstick, not on the port's path).  Then K3 and K4 whole at the cell's
    shapes and steps, and K4's device time by phase: the trajectory, the
    walk's recompute of k1..k3, the stage backwards' products, the merges
    (solve_merge), the slices' sums, and the rest (inputs, u2, epsbar and the
    bias sums)."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (fused_solve_rk4,
                                                                      fused_solve_rk4_bwd)

    out = {"products": {}, "k4_phases_ms": {}}
    for name, a, b, m, n, k, kseg, slices in wide_f32_products(dev):
        row = out["products"][name] = {"flop": 2.0 * m * n * k}
        first = _build.wide_f32_product(2, a, b, m, n, k, kseg, slices)
        for tile, label in WIDE_F32_TILES.items():
            def fn(tile=tile):
                return _build.wide_f32_product(tile, a, b, m, n, k, kseg, slices)
            same = torch.equal(fn(), first)
            us = device_ms(fn, (r"\bwide_products<",), reps=50) * 1e3
            row[label] = dict(us=us, tflops=row["flop"] / us / 1e6, bits_as_64x32=same)
        row["matmul_us"] = matmul_us(dev, m, k, n, None)
        print(f"wide-f32 {name}: " + ", ".join(
            f"{label} {row[label]['us']:.2f} us ({row[label]['tflops']:.2f} TFLOP/s"
            f"{'' if row[label]['bits_as_64x32'] else ', BITS DIFFER'})"
            for label in WIDE_F32_TILES.values())
            + f"; torch.matmul {row['matmul_us']:.2f} us "
              f"({row['flop'] / row['matmul_us'] / 1e6:.2f} TFLOP/s)", flush=True)
    b, h, nz, steps = (WIDE_F32_DIMS[k] for k in ("b", "h", "nz", "steps"))
    from continuousnormalizingflows_tpu_torch.models.nets import MLP

    params = MLP((nz + 1, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                    torch.zeros((b, 3), device=dev)], dim=-1)
    eps = torch.randn((b, nz), generator=g, device=dev)
    gbar = torch.randn((b, nz + 3), generator=g, device=dev)
    args = (u0, eps, None, params, (0.0, torch.tensor(1.05, device=dev)), nz, nz, steps)
    k3 = launches_in_order(lambda: fused_solve_rk4(*args))
    k4 = launches_in_order(lambda: fused_solve_rk4_bwd(*args, gbar))
    traj, per_step = 12 * (steps - 1), 9 + 4 * 9  # products: y-only stages; a walk step's
    seen, phases = 0, {}
    for name, us, _grid in k4:
        if "wide_products" in name:
            seen += 1
            j = seen - 2 - traj  # a product of the walk from 0
            phase = ("rest" if seen == 1 else "trajectory" if j < 0 else "rest"
                     if j >= steps * per_step else "recompute" if j % per_step < 9
                     else "stage backwards")
        elif "solve_merge" in name:
            phase = "merge"
        elif "add_slices" in name:
            phase = "slice sums"
        elif "solve_load_x" in name:
            phase = "recompute"
        else:
            phase = "rest"
        phases[phase] = phases.get(phase, 0.0) + us / 1e3
    out["k4_phases_ms"] = phases
    out["k3_ms"] = sum(us for _n, us, _g in k3) / 1e3
    out["k4_ms"] = sum(phases.values())
    out["counts"] = {t: n for t, n in _build.f32_tiles().items()}
    print(f"wide-f32 K3 {nz + 1}->{h}->{h}->{nz} B={b} steps={steps}: {out['k3_ms']:.3f} device ms "
          f"in {len(k3)} kernels; K4 {out['k4_ms']:.3f} ms in {len(k4)} kernels: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; products on each tile since the library loaded {out['counts']}", flush=True)
    return out


def launches_in_order(fn):
    """The device kernels of one call of ``fn`` (after 3 warm-up calls) in
    launch order: (short name, device us, grid), from the profiler's trace."""
    import os
    import tempfile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    return [(re.sub(r"^.*?(wide_\w+|fused_dynamics_\w+).*$", r"\1", e["name"]), e["dur"],
             e["args"].get("grid")) for e in kernels]


def matmul_us(dev, m, k, n, cdt):
    """Device us of one ``torch.matmul`` of (m x k) @ (k x n) in ``cdt``."""
    a = torch.randn((m, k), device=dev, dtype=cdt or torch.float32)
    w = torch.randn((k, n), device=dev, dtype=cdt or torch.float32)
    return device_ms(lambda: a @ w, ("",), reps=50) * 1e3  # its only kernels


def k1_phases(dev):
    """One K1 call on its wide path, kernel by kernel in launch order (device
    us of each), at the image model's and the tabular widths, fp32 and bf16;
    beside it ``torch.matmul`` of each of the chain's six products in the same
    precision and their sum: the library's time for the products the path
    launches."""
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp

    out = {}
    for h, n_in, nz, b in ((1024, 785, 784, 256), (176, 44, 43, 8_192)):
        x, eps, params, _nz, _cot = stage_inputs(dev, n_in, h, nz, b)
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            launches = launches_in_order(lambda: fused_dynamics_vjp(x, eps, params, nz, cdt))
            # F1, F2, F3 (y; u2), F4, F5 as (m, k, n)
            shapes = ((b, n_in, h), (b, h, h), (b, h, nz), (b, nz, h), (b, h, h), (b, h, nz))
            lib = [matmul_us(dev, *mkn, cdt) for mkn in shapes]
            row = out[f"K1 h={h} {prec}"] = dict(batch=b, launches=launches, matmul_us=lib,
                                                 total_us=sum(d for _n, d, _g in launches))
            print(f"k1-phases K1 {n_in}->{h}->{h}->{nz} {prec} B={b}: {row['total_us']:.1f} us "
                  f"in {len(launches)} kernels: "
                  + ", ".join(f"{n} {d:.1f}" for n, d, _g in launches)
                  + f"; torch.matmul of the six products {sum(lib):.1f} us ("
                  + ", ".join(f"{u:.1f}" for u in lib) + ")", flush=True)
    return out


def k2_phases(dev):
    """One K2 call on its wide path, kernel by kernel in launch order (device
    us of each, from the profiler's trace), at the image model's and the
    tabular widths, fp32 and bf16; beside it one ``torch.matmul`` of the
    chain's commonest product (B x h times h x h) in the same precision: the
    library's time for one of the dozen products the path launches."""
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp_bwd

    out = {}
    for h, n_in, nz, b in ((1024, 785, 784, 256), (176, 44, 43, 8_192)):
        args = stage_inputs(dev, n_in, h, nz, b)
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            launches = launches_in_order(lambda: fused_dynamics_vjp_bwd(*args, cdt))
            lib_us = matmul_us(dev, b, h, h, cdt)
            out[f"K2 h={h} {prec}"] = dict(batch=b, launches=launches, matmul_us=lib_us,
                                           total_us=sum(d for _n, d, _g in launches))
            print(f"k2-phases K2 {n_in}->{h}->{h}->{nz} {prec} B={b}: "
                  f"{out[f'K2 h={h} {prec}']['total_us']:.1f} us in {len(launches)} kernels: "
                  + ", ".join(f"{n} {d:.1f}" for n, d, _g in launches)
                  + f"; torch.matmul ({b} x {h}) @ ({h} x {h}) {lib_us:.1f} us", flush=True)
    return out


def warm_card(dev, seconds=10.0):
    """Keeps the card busy for ``seconds`` before a measurement: device times
    taken in a fresh process and after a minute of launches differ by
    1.3-1.7x (PERF.md section 6), so every run starts here."""
    a = torch.randn((4096, 4096), device=dev)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def fwd_inputs(dev, n_in, h, nz):
    """K1's and K3's inputs at batch BATCH: (x, eps, params), and K3's u0 and
    steered span."""
    x, eps, params, _nz, _cot = stage_inputs(dev, n_in, h, nz)
    g = torch.Generator(device=dev).manual_seed(2)
    u0 = torch.cat([0.5 * torch.randn((BATCH, nz), generator=g, device=dev),
                    torch.zeros((BATCH, 3), device=dev)], dim=-1)
    return x, eps, params, u0, (0.0, torch.tensor(1.05, device=dev))


def fwd_calls(dev, n_in, h, nz, cdt):
    """{"K1": one stage, "K3": a 32-step solve} at these widths; K3's net
    input is [z, t]: n_in = nz + 1."""
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import fused_solve_rk4

    x, eps, params, u0, span = fwd_inputs(dev, n_in, h, nz)
    return {"K1": lambda: fused_dynamics_vjp(x, eps, params, nz, cdt),
            "K3": lambda: fused_solve_rk4(u0, eps, None, params, span, nz, nz, 32, cdt)}


FWD_SHAPES = {8: (6, 5), 12: (3, 2), 16: (6, 5), 24: (6, 5), 32: (6, 5)}  # h: (n_in, nz)


def fwd_widths(dev):
    """K1 and K3 over the hidden widths of the forward row path at batch
    65,536, fp32 and bf16 (h = 12 at the FFJORD form's widths 3 -> 12 -> 12
    -> 2, the rest 6 -> h -> h -> 5): device ms of each kernel's launches,
    with the H its plan names.  Run from two checkouts in one call, it
    compares their kernels width by width."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    out = {}
    for h, (n_in, nz) in FWD_SHAPES.items():
        for cdt, prec in ((None, "fp32"), (torch.bfloat16, "bf16")):
            calls = fwd_calls(dev, n_in, h, nz, cdt)
            for k, fn in calls.items():
                sd = nz + 3 if k == "K3" else 0
                rows, _staged, h_pad = _build.plan(n_in, h, nz, nz, sd)[:3]
                res = fn()
                bits = digest(res if isinstance(res, tuple) else [res])
                ms = sorted(device_ms(fn, KERNELS[k], reps=30 if k == "K1" else 10)
                            for _ in range(3))
                out[f"{k} h={h} {prec}"] = dict(H=h_pad, rows=rows, ms=ms[1], min=ms[0],
                                                max=ms[2], digest=bits)
                print(f"fwd-widths {k} {n_in}->{h}->{h}->{nz} {prec} B={BATCH} (H = {h_pad}, "
                      f"{rows} threads a block): device ms {ms[1]:.4f} (min {ms[0]:.4f}, "
                      f"max {ms[2]:.4f}), bits {bits}", flush=True)
    return out


SASS_KERNELS = ("fused_dynamics_fwd_rows", "fused_solve_rk4_rows", "adaptive_fwd_rows",
                "adaptive_replay")


def _opcode_mix(lines):
    """Counts of the SASS instructions of one function by opcode (MUFU by
    its function: MUFU.EX2, MUFU.RCP, ...)."""
    mix = {}
    for line in lines:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)"
                      r"((?:\.[A-Z0-9_]+)*)", line)
        if m:
            op = m.group(1) + ("." + m.group(2).split(".")[1] if m.group(1) == "MUFU" else "")
            mix[op] = mix.get(op, 0) + 1
    return mix


def sass(dev):
    """The row kernels of the forward solves in the built library (K1
    ``fused_dynamics_fwd_rows<H, bf16>``, K3 ``fused_solve_rk4_rows<H,
    bf16>``, K5 ``adaptive_fwd_rows<H>`` and K6's replay
    ``adaptive_replay<H>``): registers and local memory, spill bytes (the
    build's ptxas lines), resident blocks an SM at the plan's block and
    shared memory for the flagship (h = 24) and FFJORD (h = 12) widths
    (K5's and the replay's: a 128-row control group a block), and the
    instruction mix (printed for the kernels those widths take, all of them
    in the JSON).  Stage copies in the code = MUFU.EX2 / 2H (one exponential
    a gate, 2H gates a stage)."""
    from chip_smoke import kernel_label, ptxas_usage, resident_blocks
    from continuousnormalizingflows_tpu_torch.ops import _build

    _build.kernels()
    lib = _build.build_info["path"]
    ptxas = ptxas_usage(_build.build_info["log"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    usage = {}
    for name, body in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", res):
        usage[kernel_label(name)] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", body)}
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\s*\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        label = kernel_label(name)
        if not label.startswith(SASS_KERNELS):
            continue
        mix = _opcode_mix(body.splitlines())
        m = re.search(r"<(\d+)", label)  # no H: the tiled replay
        H = int(m.group(1)) if m else 0
        copies = mix.get("MUFU.EX2", 0) / (2 * H) if H else None
        out[label] = dict(usage=usage.get(label, {}), mix=mix, instructions=sum(mix.values()),
                          stage_copies=copies,
                          spill_bytes=[ptxas.get(label, {}).get(k) for k in ("spill_stores",
                                                                             "spill_loads")])
    for h, (n_in, nz) in ((24, (6, 5)), (12, (3, 2))):
        shapes = []
        for sd, name in ((0, "fused_dynamics_fwd_rows"), (nz + 3, "fused_solve_rk4_rows")):
            rows, _staged, H = _build.plan(n_in, h, nz, nz, sd)[:3]
            wf = n_in * H + 2 * H * H + nz * H + 2 * H + nz
            smem = 4 * (wf + (rows * ((2 * sd + n_in + nz + nz) | 1) if sd else 0))
            shapes += [(f"{name}<{H}, {bf16}>", rows, smem) for bf16 in (0, 1)]
        H, _rows, smem = _build.adaptive_plan(n_in, h, nz, nz, nz + 3, 128)[:3]
        shapes += [(f"{name}<{H}>", 128, smem) for name in ("adaptive_fwd_rows", "adaptive_replay")]
        for label, threads, smem in shapes:
            if label not in out:
                continue
            blocks, by_regs, by_smem = resident_blocks(out[label]["usage"].get("REG", 0),
                                                       threads, smem)
            out[label][f"h={h}"] = dict(threads=threads, smem_bytes=smem, resident_blocks=blocks,
                                        by_registers=by_regs, by_shared_memory=by_smem)
    for label, r in sorted(out.items()):
        if not any(k.startswith("h=") for k in r):
            continue
        top = sorted(r["mix"].items(), key=lambda kv: -kv[1])[:14]
        mufu = {op: n for op, n in r["mix"].items() if op.startswith("MUFU")}
        shapes = "; ".join(f"{k}: {v['threads']} threads, {v['smem_bytes']} B shared, "
                           f"{v['resident_blocks']} blocks an SM (registers allow "
                           f"{v['by_registers']}, shared memory {v['by_shared_memory']})"
                           for k, v in r.items() if k.startswith("h="))
        print(f"sass {label}: {r['usage']}; spill bytes (stores, loads; None: built earlier) "
              f"{r['spill_bytes']}; "
              f"{r['instructions']} instructions, {r['stage_copies']:.2f} stage copies; "
              f"{shapes}; {mufu}; top " + ", ".join(f"{op} {n}" for op, n in top), flush=True)
    return out


# hidden width: (n_in, nz) of K5's widths; h = 12 is the FFJORD form (3 -> 12 ->
# 12 -> 2, state 5), h = 33 and 128 take the tiled path
ADAPTIVE_WIDTHS = {8: (6, 5), 12: (3, 2), 16: (6, 5), 24: (6, 5), 32: (6, 5), 33: (6, 5),
                   128: (6, 5)}


def adaptive_widths(dev):
    """K5 alone over the hidden widths (batch 65,536; 8,192 at h = 128) at
    rtol = atol = 1e-4 and 1e-6: device ms of K5's kernel beside its NFE
    summed over the 128-row groups, and, where K6's replay is a kernel of its
    own (h <= 32), the replay's device ms.  Per width, the line through the
    two tolerances' (mean NFE a group, ms) gives K5's cost a stage evaluation
    (slope) and its fixed cost (intercept); it holds where every group takes
    the same NFE (a launch waits for its slowest group).  Run from two
    checkouts in one call, it compares their K5 width by width."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    out = {}
    for h, (n_in, nz) in ADAPTIVE_WIDTHS.items():
        b, sd = (8_192 if h == 128 else BATCH), nz + 3
        params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                        torch.zeros((b, 3), device=dev)], dim=-1)
        eps = torch.randn((b, nz), generator=g, device=dev)
        gbar = torch.randn((b, sd), generator=g, device=dev)
        span = (0.0, torch.tensor(1.05, device=dev))
        plan = _build.adaptive_plan(n_in, h, nz, nz, sd, 128)
        path = f"row, H = {plan[0]}" if plan[0] else f"tiled, {plan[1]} rows a tile"
        points = []
        for tol in (1e-4, 1e-6):
            args = (u0, eps, None, params, span, nz, nz, (tol, tol, 0.01, 0.9, 0.2, 10.0, 16_384))
            k5 = lambda: fa.fused_solve_dopri5(*args, 128)
            st = k5()[1]
            nfe = int(st[:, 0].sum())
            ms = sorted(device_ms(k5, KERNELS["K5"], reps=10) for _ in range(3))
            row = out[f"K5 h={h} tol={tol:g}"] = dict(
                path=path, batch=b, groups=st.shape[0], nfe=nfe, nfe_max=int(st[:, 0].max()),
                accepted=int(st[:, 1].sum()), ms=ms[1], min=ms[0], max=ms[2])
            replay = ""
            if plan[0]:
                k6 = lambda: fa.fused_solve_dopri5_bwd(*args, 128, gbar)
                if not torch.equal(k6()[3], st[:, 1].to(torch.int32)):
                    raise SystemExit(f"adaptive-widths h={h} tol={tol:g}: the replay's accepted "
                                     f"steps differ from K5's")
                rms = sorted(device_ms(k6, ("adaptive_replay",), reps=5) for _ in range(3))
                row.update(replay_ms=rms[1], replay_min=rms[0], replay_max=rms[2])
                replay = f"; K6's replay {rms[1]:.4f} (min {rms[0]:.4f}, max {rms[2]:.4f})"
            points.append((nfe / st.shape[0], ms[1]))
            print(f"adaptive-widths K5 {n_in}->{h}->{h}->{nz} tol {tol:g} B={b} ({path}): NFE "
                  f"{nfe} over {st.shape[0]} groups (at most {row['nfe_max']} a group), accepted "
                  f"{row['accepted']}; device ms {ms[1]:.4f} (min {ms[0]:.4f}, max {ms[2]:.4f})"
                  f"{replay}", flush=True)
        (n1, t1), (n2, t2) = points
        slope = (t2 - t1) / (n2 - n1) if n2 != n1 else float("nan")
        out[f"K5 h={h} line"] = dict(us_per_nfe=slope * 1e3, intercept_us=(t1 - slope * n1) * 1e3)
        print(f"adaptive-widths K5 h={h}: {slope * 1e3:.3f} us a stage evaluation (mean NFE a "
              f"group {n1:.2f} -> {n2:.2f}), fixed {(t1 - slope * n1) * 1e3:.3f} us", flush=True)
    return out


ADAPTIVE_WIDE = ([((6, h, 5), b) for h in (33, 48, 64, 96, 128) for b in (8_192, 65_536)]
                 + [((42, 128, 41), b) for b in (16_384, 65_536)])


def adaptive_wide(dev):
    """K5 and K6 above their row paths, on the cluster path with 2 and with 4
    CTAs a group (``fused_adaptive._WIDE_PATH`` "cluster2", "cluster4") and on
    the tiled path, in turns (2, 4, tiled, tiled, 4, 2): device ms of each
    kernel's launches, the cluster plan and the path and size the wrapper
    picks, NFE and accepted steps (the same on every path: K5 gives the same
    bits on each, which is checked).  A size that does not fit a shape is
    left out of it.  The draws are chip_smoke.py's h = 128 case (doubled
    weights, each 128-row group scaled by 0.1-10, the first step half the
    span).  K6 is ``fused_solve_dopri5_bwd``: on the cluster paths its
    record is written by K5's kernel first, which the K6 row leaves out (a
    train step's K6 walks K5's record), while the tiled path's K6 holds its
    replay."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    out = {}
    for (n_in, h, nz), b in ADAPTIVE_WIDE:
        sd = nz + 3
        params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
        params = {k: 2.0 * v for k, v in params.items()}
        g = torch.Generator(device=dev).manual_seed(1)
        z0 = 0.5 * torch.randn((b, nz), generator=g, device=dev)
        z0 = z0 * torch.logspace(-1, 1, b // 128, device=dev).repeat_interleave(128)[:, None]
        u0 = torch.cat([z0, torch.zeros((b, 3), device=dev)], dim=-1)
        eps = torch.randn((b, nz), generator=g, device=dev)
        gbar = torch.randn((b, sd), generator=g, device=dev)
        args = (u0, eps, None, params, (0.0, torch.tensor(1.05, device=dev)), nz, nz,
                (1e-4, 1e-4, 0.5, 0.9, 0.2, 10.0, 16_384))
        k5 = lambda: fa.fused_solve_dopri5(*args, 64)
        k6 = lambda: fa.fused_solve_dopri5_bwd(*args, 64, gbar)
        plans = {c: _build.cluster_plan(n_in, h, nz, nz, sd, 128, b, c) for c in (2, 4)}
        paths = [f"cluster{c}" for c in (2, 4) if plans[c].cluster] + ["tiled"]
        picked = _build.cluster_plan(n_in, h, nz, nz, sd, 128, b).cluster
        picked = f"cluster{picked}" if picked else "tiled"
        t, bits = {w: [] for w in paths}, {}
        try:
            for wide in paths + paths[::-1]:
                fa._WIDE_PATH = wide
                u1, st = k5()
                bits.setdefault(wide, digest([u1, st]))
                t[wide].append((device_ms(k5, KERNELS["K5"], reps=2, warmup=1),
                                device_ms(k6, KERNELS["K6"], reps=1, warmup=1)))
        finally:
            fa._WIDE_PATH = None
        if len(set(bits.values())) != 1:
            raise SystemExit(f"adaptive-wide {n_in}->{h}->{nz} B={b}: K5's bits differ "
                             f"between the paths: {bits}")
        ms = {w: [sorted(v[i] for v in runs)[len(runs) // 2] for i in (0, 1)]
              for w, runs in t.items()}
        row = out[f"{n_in}->{h}->{h}->{nz} B={b}"] = dict(
            plans={c: p._asdict() for c, p in plans.items()}, picked=picked,
            nfe=int(st[:, 0].sum()), nfe_max=int(st[:, 0].max()), accepted=int(st[:, 1].sum()),
            **{f"{k}_{w}": ms[w][i] for w in ms for i, k in enumerate(("k5", "k6"))}, runs=t)
        fastest = {k: min(ms, key=lambda w: ms[w][i]) for i, k in enumerate(("K5", "K6"))}
        words = "; ".join(
            f"{w} K5 {ms[w][0]:.4f} ms, K6 {ms[w][1]:.4f} ms"
            + (f" (weights resident K5 {plans[int(w[-1])].res_fwd}, K6 walk "
               f"{plans[int(w[-1])].res_bwd}; state on chip {plans[int(w[-1])].state_fwd}; walk "
               f"passes of {plans[int(w[-1])].walk_rows})" if w != "tiled" else "")
            for w in paths)
        print(f"adaptive-wide {n_in}->{h}->{h}->{nz} B={b}: picked {picked}; NFE {row['nfe']} "
              f"over {b // 128} groups (at most {row['nfe_max']}); {words}; fastest K5 "
              f"{fastest['K5']}, K6 {fastest['K6']}; K5 bits equal on every path "
              f"{next(iter(bits.values()))}", flush=True)
    return out


NCCL_BATCHES = (256, 1024)  # the digits fit's global batch a step
NCCL_STEPS = 16
NCCL_JOIN_S = 420


def nccl_runs(dev, mesh=None, profile=False):
    """The ``nccl`` mode's runs on this process's card, with ``mesh=`` or
    alone: the digits fit at each of NCCL_BATCHES (``(rate, params,
    profile, collectives)``) and the default stack's step (the second of
    two, by the host clock)."""
    import functools

    import chip_smoke as cs
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.utils import datasets as ds

    xd = ds.smooth_image_mixture(torch.Generator(device=dev).manual_seed(3),
                                 NCCL_STEPS * max(NCCL_BATCHES), cs.DIGITS_SIDE)
    shift = functools.partial(ds.random_shift_images, side=cs.DIGITS_SIDE, prob=0.5)
    icnf = cs.image_model(cs.DIGITS_SIDE, cs.DIGITS_HIDDEN, fused=True)
    where = f"{mesh.size()} NCCL ranks" if mesh is not None else "one card"
    out = {}
    for b in NCCL_BATCHES:
        prof = {} if profile else None
        with cs.ShardStepSpy() as spy:
            res, rate, _launched = cs.image_fit(
                f"digits-shaped, {where}, batch {b}", icnf, xd, NCCL_STEPS,
                dict(cs.NO_LAUNCH, K3=1, K4=1), dev, batch_transform=shift, mesh=mesh,
                profile=prof, batch=b)
        out[b] = dict(rate=rate, params={k: v.cpu() for k, v in res.params.items()},
                      profile=prof, collectives=dict(spy.made[-1].counts) if spy.made else {})
    x = ds.gaussian_mixture(torch.Generator(device=dev).manual_seed(1), cs.BATCH)
    default = cnf.ICNF.create(nvariables=2)
    run = ((lambda: cs.sharded_grads(default, x, mesh, 11)) if mesh is not None
           else (lambda: cs.whole_grads(default, x, 11)))
    run()
    step, secs = cs.host_seconds(run)
    out["default"] = dict(step, seconds=secs)
    return out


def nccl_rank(rank, world, store, work):
    """A rank of the ``nccl`` mode: card ``rank``, results to
    ``work/r<rank>.pt``, a failure's traceback to ``work/error_r<rank>.txt``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from continuousnormalizingflows_tpu_torch.parallel import initialize_distributed, make_mesh

    try:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        initialize_distributed(backend="nccl", init_method=f"file://{store}",
                               world_size=world, rank=rank, device_id=dev,
                               timeout=datetime.timedelta(seconds=NCCL_JOIN_S))
        out = nccl_runs(dev, make_mesh(), profile=rank == 0)
        torch.save(out, Path(work) / f"r{rank}.pt")
        dist.destroy_process_group()
    except Exception:
        (Path(work) / f"error_r{rank}.txt").write_text(traceback.format_exc())
        raise


def nccl(dev):
    """The parallel layer on every card of the machine, against card 0 alone."""
    import multiprocessing as mp

    import chip_smoke as cs

    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit("nccl: needs a machine with several cards")
    one = nccl_runs(dev)
    work = Path("chiprun_out/nccl_mode").resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=nccl_rank, args=(r, world, str(work / "store"), str(work)))
             for r in range(world)]
    start = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, NCCL_JOIN_S - (time.perf_counter() - start)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(work.glob("error_r*.txt"))]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"nccl: ranks hung {hung}, exit codes {[p.exitcode for p in procs]}\n"
                         + "\n".join(errors))
    ranks = [torch.load(work / f"r{r}.pt") for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    out = {"world": world, "card": cs.nvidia_smi()}
    for b in NCCL_BATCHES:
        got = ranks[0][b]
        err = cs.compare_to_max(f"nccl: {world} ranks' digits params vs one card's, batch {b}",
                                [got["params"][k] for k in one[b]["params"]],
                                list(one[b]["params"].values()), cs.PARALLEL_PARAM_TOL)
        out[b] = dict(rate_one=one[b]["rate"], rates=[r[b]["rate"] for r in ranks],
                      speedup=got["rate"] / one[b]["rate"], profile=got["profile"],
                      collectives=got["collectives"], params_max_abs_err=err)
        print(f"nccl batch {b}: one card {one[b]['rate']:.1f} train samples/s, {world} ranks "
              f"{got['rate']:.1f} ({out[b]['speedup']:.3f}x); collectives a step "
              f"{got['collectives']}; rank 0's step: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in got["profile"].items()), flush=True)
    d1, dw = one["default"], ranks[0]["default"]
    if any(r["default"]["stats"] != d1["stats"] for r in ranks):
        raise SystemExit(f"nccl: default stack stats {[r['default']['stats'] for r in ranks]} "
                         f"vs one card's {d1['stats']}")
    out["default"] = dict(seconds_one=d1["seconds"], seconds=[r["default"]["seconds"]
                                                             for r in ranks],
                          stats=d1["stats"], collectives=dw["collectives"])
    print(f"nccl default stack, 65,536 rows: one card {d1['seconds'] * 1e3:.3f} ms a step, "
          f"{world} ranks {dw['seconds'] * 1e3:.3f} ms; stats {d1['stats']} on every rank; "
          f"collectives {dw['collectives']} ({out['card']})", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs an NVIDIA GPU", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from continuousnormalizingflows_tpu_torch.ops import _build

    _build.kernels()
    count_trials()
    warm_card(dev)
    table = rows(dev)
    wanted = sys.argv[1:] or list(table)
    out = {"device": torch.cuda.get_device_name(0)}
    for name, mode in (("sass", sass), ("k2-grid", k2_grid), ("k2-wide", k2_wide),
                       ("k2-phases", k2_phases), ("k1-wide", k1_wide), ("k1-phases", k1_phases),
                       ("solve-wide", solve_wide), ("wide-f32", wide_f32),
                       ("widths", widths),
                       ("fwd-widths", fwd_widths), ("adaptive-widths", adaptive_widths),
                       ("adaptive-wide", adaptive_wide),
                       ("nccl", nccl)):
        if name in wanted:
            wanted.remove(name)
            out[name] = mode(dev)
    for name in wanted:
        r = out[name] = table[name]()
        per_trial = (f" ({r['kernels_per_trial_step']:.1f} a trial step of "
                     f"{r['trial_steps_per_step']:.1f})" if r["kernels_per_trial_step"] else "")
        print(f"{name}: {r['kernels_per_step']:.0f} kernels{per_trial}, busy {r['busy_ms']:.3f} "
              f"ms of {r['wall_ms']:.3f} ms profiled wall, idle share {r['idle_share']:.3f}; "
              + "".join(f"{k} {ms:.3f} ms, " for k, ms in r["kernel_ms"].items() if ms)
              + "top "
              + ", ".join(f"{k} {ms:.3f} ms ({n:.0f}x)" for k, ms, n in r["top"]), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_profile.json").write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
