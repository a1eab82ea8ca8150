"""Device-time profile of the PyTorch port on one NVIDIA GPU: the train steps
and serving calls of PERF.md section 5.

    python3 chip_profile.py [row ...]
    python3 chip_profile.py k2-grid
    python3 chip_profile.py widths

Each row runs the flagship 2-D RNODE (or its FFJORD form) at 65,536 samples
under ``torch.profiler``: 2 warm-up steps or calls, then 3 profiled ones.  Per
row it prints the device kernels per step, the summed device time of those
kernels ("busy"), the host wall time of the profiled steps (inflated by the
profiler), the idle share ``1 - busy / wall`` and the top kernels, and
writes every row to ``chiprun_out/chip_profile.json``.  With no arguments
it runs every row.  The kernels build at first use, as in ``chip_smoke.py``.
K6 shows as its two kernels, ``adaptive_replay`` and ``walk_rows`` (above h =
32 as one, ``adaptive_bwd``), K4 as ``solve_traj_rows`` and
``fused_solve_rk4_bwd_rows``.

``k2-grid`` is the measurement behind K2's launch shape on its row path:
it builds the kernels a second time with ``-DCNF_K2_ONE_BLOCK_A_TILE`` (a
block for every 64-row tile instead of at most 264 blocks that take tiles in
turn) and times K2 in both builds, in turns, at the flagship and the FFJORD
widths.  ``widths`` times K2 and K6 at every hidden width of the row path and
just past it (h = 8 ... 33), by the device time of their kernels: the
measurement behind the rule that h <= 32 takes that path.  Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

BATCH = 65_536
WARMUP, ACTIVE = 2, 3


def summarize(prof, wall_s):
    events = prof.key_averages()
    # device events that carry a host op's name are annotations (ProfilerStep*,
    # Optimizer.step#...) spanning kernels, not kernels
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ACTIVE
    wall_ms = wall_s * 1e3 / ACTIVE
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(kernels_per_step=sum(e.count for e in kernels) / ACTIVE, busy_ms=busy_ms,
                wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms,
                top=[(e.key[:70], e.self_device_time_total / 1e3 / ACTIVE, e.count / ACTIVE)
                     for e in top])


def profiled(step):
    """``step(callback)`` runs WARMUP + ACTIVE steps, calling ``callback``
    after each."""
    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=WARMUP, active=ACTIVE, repeat=1)) as prof:
        def callback(*_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            prof.step()

        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        step(callback)
    return summarize(prof, marks[WARMUP + ACTIVE] - marks[WARMUP])


def fit_row(dev, data, **create):
    import continuousnormalizingflows_tpu_torch as cnf

    icnf = cnf.ICNF.create(nvariables=2, **create)
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    steps_per_epoch = data.shape[0] // BATCH
    epochs = -(-(WARMUP + ACTIVE) // steps_per_epoch)

    def step(callback):
        cnf.ICNFModel(icnf, batchsize=BATCH, epochs=epochs, log_every=1, callback=callback,
                      device=dev, generator=torch.Generator(device=dev).manual_seed(7),
                      ).fit(data, params=params)

    return lambda: profiled(step)


def call_row(dev, x, mode, **create):
    import continuousnormalizingflows_tpu_torch as cnf

    icnf = cnf.ICNF.create(nvariables=2, **create)
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)

    def step(callback):
        with torch.no_grad():
            for i in range(WARMUP + ACTIVE):
                gen = torch.Generator(device=dev).manual_seed(2 + i)
                cnf.ICNFDist(icnf, params, mode, gen).logpdf(x)
                callback()

    return lambda: profiled(step)


def rows(dev):
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    data = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), 4 * BATCH)
    x = data[:BATCH]
    rk4 = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)
    ffjord = dict(naugments=0, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0)
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
        "serving rk4 TEST logpdf, fused": call_row(dev, x, Mode.TEST, solver=rk4, fused=True),
        "serving rk4 TRAIN logpdf, fused (K3)": call_row(dev, x, Mode.TRAIN, solver=rk4,
                                                         fused=True),
        "serving default stack TEST logpdf": call_row(dev, x, Mode.TEST),
        "serving default stack TRAIN logpdf": call_row(dev, x, Mode.TRAIN),
    }


def device_ms(fn, names, reps=30):
    """Device time of one call of ``fn``: the summed time of the kernels whose
    name holds one of ``names``, over ``reps`` profiled calls after 5 warm-up
    ones.  A CUDA-event time around a call would also hold the wrapper's host
    time wherever the card waits for it, as it does at these widths."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if any(n in e.key for n in names))
    return total / 1e3 / reps


K2_KERNELS = ("fused_dynamics_bwd", "reduce_partials")
K6_KERNELS = ("adaptive_bwd", "adaptive_replay", "walk_rows", "reduce_partials")


def stage_inputs(dev, n_in, h, nz):
    from continuousnormalizingflows_tpu_torch.models.nets import MLP

    params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((BATCH, n_in), generator=g, device=dev)
    eps = torch.randn((BATCH, nz), generator=g, device=dev)
    cot = (torch.randn((BATCH, nz), generator=g, device=dev),
           torch.randn((BATCH, nz), generator=g, device=dev),
           *torch.randn((3, BATCH), generator=g, device=dev))
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
        path = f"row, H = {plan[4]}" if plan[4] else f"tiled, {plan[0]} rows a tile"
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
        plan = _build.adaptive_plan(n_in, h, nz, nz, nz + 3, 128)
        ms = sorted(device_ms(fn, K6_KERNELS, reps=5) for _ in range(3))
        out[f"K6 h={h}"] = dict(plan=list(plan), ms=ms[1], min=ms[0], max=ms[2],
                                accepted=[int(nacc.min()), int(nacc.max())])
        print(f"widths K6 {n_in}->{h}->{h}->{nz} fp32 B={BATCH} (plan {plan}; accepted steps "
              f"{int(nacc.min())}-{int(nacc.max())} a group): device ms {ms[1]:.4f} "
              f"(min {ms[0]:.4f}, max {ms[2]:.4f})", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs an NVIDIA GPU", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from continuousnormalizingflows_tpu_torch.ops import _build

    _build.kernels()
    table = rows(dev)
    wanted = sys.argv[1:] or list(table)
    out = {"device": torch.cuda.get_device_name(0)}
    for name, mode in (("k2-grid", k2_grid), ("widths", widths)):
        if name in wanted:
            wanted.remove(name)
            out[name] = mode(dev)
    for name in wanted:
        r = out[name] = table[name]()
        print(f"{name}: {r['kernels_per_step']:.0f} kernels, busy {r['busy_ms']:.3f} ms of "
              f"{r['wall_ms']:.3f} ms profiled wall, idle share {r['idle_share']:.3f}; top "
              + ", ".join(f"{k} {ms:.3f} ms ({n:.0f}x)" for k, ms, n in r["top"]), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_profile.json").write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
