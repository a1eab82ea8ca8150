"""Device-time profile of the PyTorch port on one NVIDIA GPU: the train steps
and serving calls of PERF.md section 5.

    python3 chip_profile.py [row ...]

Each row runs the flagship 2-D RNODE (or its FFJORD form) at 65,536 samples
under ``torch.profiler``: 2 warm-up steps or calls, then 3 profiled ones.  Per
row it prints the device kernels per step, the summed device time of those
kernels ("busy"), the host wall time of the profiled steps (inflated by the
profiler), the idle share ``1 - busy / wall`` and the top kernels, and
writes every row to ``chiprun_out/chip_profile.json``.  With no arguments
it runs every row.  The kernels build at first use, as in ``chip_smoke.py``.
Imports nothing of JAX.
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
    for name in wanted:
        r = out[name] = table[name]()
        print(f"{name}: {r['kernels_per_step']:.0f} kernels, busy {r['busy_ms']:.3f} ms of "
              f"{r['wall_ms']:.3f} ms profiled wall, idle share {r['idle_share']:.3f}; top "
              + ", ".join(f"{k} {ms:.3f} ms ({n:.0f}x)" for k, ms, n in r["top"]), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_profile.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
