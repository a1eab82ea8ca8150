"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``continuousnormalizingflows_tpu_torch/csrc``,
holds each (forward K1, K3 and backward K2, K4) against its plain PyTorch
version at the flagship and tabular shapes in both precisions, drives the
flagship RNODE's log-density and sampling path (65,536 samples) through the
public entry points, then trains it with ``ICNFModel.fit`` (batch 65,536,
32 steps through K3 + K4) and its FFJORD form (through K1 + K2), and checks
that the kernels carried each path.  Imports nothing of JAX.  Exits
non-zero, with no result line, when there is no CUDA device or any phase
fails; on success the last line is ``{"ok": true, "device": {...}}``.  A detailed record goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = 65_536
STEPS = 32
TABULAR_BATCH = 8_192
TRAIN_POINTS = 4 * 65_536  # 4 steps an epoch at the flagship batch
TRAIN_EPOCHS = 8

# (rtol, atol) by (kernel, precision); reasons in tests/test_torch_kernels_cuda.py
TOL = {
    ("stage", None): (1e-4, 1e-5),
    ("stage", torch.bfloat16): (2e-2, 2e-2),
    ("solve", None): (5e-4, 5e-5),
    ("solve", torch.bfloat16): (5e-2, 5e-2),
}
# fused vs unfused log-density of the slice: the same fp32 32-step solve, the
# probe VJP by hand in one and by autograd in the other
SLICE_TOL = (5e-4, 5e-5)
# backward kernels vs their plain versions, per output tensor as
# max|kernel - plain| <= tol * max|plain| (a weight gradient sums over every
# row and stage, so its small entries carry the absolute error of the
# largest); reasons in tests/test_torch_kernels_cuda.py
BWD_TOL = {("stage", None): 1e-4, ("stage", torch.bfloat16): 3e-2,
           ("solve", None): 5e-4, ("solve", torch.bfloat16): 6e-2}
# one train step's parameter gradients, fused vs unfused route, same draws:
# the same fp32 32-step solve and its exact backward, by hand in one and by
# autograd in the other, summed over 65,536 rows
GRAD_TOL = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error; fails unless every element is within atol + rtol*|want|."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite kernel output")
        diff = (a - b).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / b.abs().clamp_min(1e-12)).max()))
        bad = diff > atol + rtol * b.abs()
        if bad.any():
            fail(f"{name}: {int(bad.sum())} elements outside rtol={rtol} atol={atol} "
                 f"(max abs {float(diff.max()):.3e})")
    log(f"  {name}: max abs {worst_abs:.3e}, max rel {worst_rel:.3e} "
        f"(rtol {rtol}, atol {atol}) ok")
    return worst_abs


def compare_to_max(name: str, got, want, tol: float) -> float:
    """Max abs error; fails unless each tensor is within tol * max|want|."""
    worst, worst_ratio = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: tensor {i} non-finite or of shape {tuple(a.shape)}")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if err > tol * scale:
            fail(f"{name}: tensor {i} max abs err {err:.3e} > {tol} x max |plain| {scale:.3e}")
        worst, worst_ratio = max(worst, err), max(worst_ratio, err / max(scale, 1e-30))
    log(f"  {name}: max abs {worst:.3e}, worst max-abs/max|plain| {worst_ratio:.3e} "
        f"(tol {tol} per tensor) ok")
    return worst


def flat(out):
    """(xbar, epsbar, weight grads) -> one list of tensors"""
    return [out[0], out[1], *out[2]]


def kernel_phase(dev, record):
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
        fused_dynamics_vjp, fused_dynamics_vjp_bwd, fused_dynamics_vjp_bwd_reference,
        mlp3_forward_vjp_reference)
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
        fused_solve_rk4, fused_solve_rk4_bwd, fused_solve_rk4_bwd_reference,
        fused_solve_rk4_reference)

    # (name, n_in, h, nz, batch): the flagship and the tabular width (naugments=0)
    shapes = [("flagship", 6, 24, 5, BATCH), ("tabular", 44, 176, 43, TABULAR_BATCH)]
    results = []
    for shape, n_in, h, nz, b in shapes:
        params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((b, n_in), generator=g, device=dev)
        eps = torch.randn((b, nz), generator=g, device=dev)
        u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                        torch.zeros((b, 3), device=dev)], dim=-1)
        span = (0.0, torch.tensor(1.05, device=dev))  # steered t1 as a device scalar
        # cotangents: of K1's five outputs, and of K3's u1
        cot = (torch.randn((b, nz), generator=g, device=dev),
               torch.randn((b, nz), generator=g, device=dev),
               *torch.randn((3, b), generator=g, device=dev))
        gbar = torch.randn((b, nz + 3), generator=g, device=dev)
        for kname, sd in (("K1", 0), ("K3", nz + 3)):
            rows, staged, h_pad = _build.plan(n_in, h, nz, nz, sd)
            path = f"row per thread, h padded to {h_pad}" if h_pad else "tiled"
            log(f"  plan {kname} {shape}: {path}, {rows} rows/block, weights in smem: {staged}")
        for kname, sd in (("K2", 0), ("K4", nz + 3)):
            rows, staged, grid, n_params = _build.bwd_plan(n_in, h, nz, nz, sd, b)
            log(f"  plan {kname} {shape}: tiled, {rows} rows/tile, grid {grid}, "
                f"{n_params} params, weights in smem: {staged}")
        for cdt in (None, torch.bfloat16):
            prec = "fp32" if cdt is None else "bf16"
            stage = lambda: fused_dynamics_vjp(x, eps, params, nz, cdt)
            stage_ref = lambda: mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
            solve = lambda: fused_solve_rk4(u0, eps, None, params, span, nz, nz, STEPS, cdt)
            solve_ref = lambda: fused_solve_rk4_reference(u0, eps, None, params, span, nz, nz,
                                                         STEPS, cdt)
            stage_bwd = lambda: fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
            stage_bwd_ref = lambda: fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot,
                                                                     cdt)
            solve_bwd = lambda: fused_solve_rk4_bwd(u0, eps, None, params, span, nz, nz, STEPS,
                                                    gbar, cdt)
            solve_bwd_ref = lambda: fused_solve_rk4_bwd_reference(u0, eps, None, params, span,
                                                                  nz, nz, STEPS, gbar, cdt)
            err1 = compare(f"K1 fused_dynamics {shape} {prec} B={b}", stage(), stage_ref(),
                           *TOL[("stage", cdt)])
            err3 = compare(f"K3 fused_solve_rk4 {shape} {prec} B={b} steps={STEPS}", solve(),
                           solve_ref(), *TOL[("solve", cdt)])
            err2 = compare_to_max(f"K2 fused_dynamics_bwd {shape} {prec} B={b}",
                                  flat(stage_bwd()), flat(stage_bwd_ref()),
                                  BWD_TOL[("stage", cdt)])
            k4 = flat(solve_bwd())
            err4 = compare_to_max(f"K4 fused_solve_rk4_bwd {shape} {prec} B={b} steps={STEPS}",
                                  k4, flat(solve_bwd_ref()), BWD_TOL[("solve", cdt)])
            if not all(torch.equal(a, c) for a, c in zip(k4, flat(solve_bwd()))):
                fail(f"K4 {shape} {prec}: two calls on the same inputs differ")
            log(f"  K4 {shape} {prec}: two calls give the same bits ok")
            # plain, kernel, kernel, plain: the two versions in turns
            pairs = {"k1": (stage, stage_ref, 20, 10), "k3": (solve, solve_ref, 10, 3),
                     "k2": (stage_bwd, stage_bwd_ref, 20, 10),
                     "k4": (solve_bwd, solve_bwd_ref, 3, 3)}
            t = {k + s: [] for k in pairs for s in ("", "_plain")}
            for order in (("plain", "kernel"), ("kernel", "plain")):
                for which in order:
                    for k, (kern, plain, reps_k, reps_p) in pairs.items():
                        if which == "plain":
                            t[k + "_plain"].append(median_ms(plain, reps_p))
                        else:
                            t[k].append(median_ms(kern, reps_k))
            ms = {k: statistics.median(v) for k, v in t.items()}
            log(f"  time {shape} {prec}: " + "; ".join(
                f"{k.upper()} {ms[k]:.4f} ms vs plain {ms[k + '_plain']:.4f} ms" for k in pairs))
            results.append(dict(shape=shape, precision=prec, batch=b, widths=[n_in, h, h, nz],
                                k1_max_abs_err=err1, k2_max_abs_err=err2, k3_max_abs_err=err3,
                                k4_max_abs_err=err4, **ms))
    record["kernels_vs_plain"] = results
    return results


def host_seconds(fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def samples_per_s(name, fn, n, reps=3):
    """Median host-clock rate of ``reps`` calls (after the counted one)."""
    secs = sorted(host_seconds(fn)[1] for _ in range(reps))
    sec = secs[len(secs) // 2]
    log(f"  {name}: {n / sec:.1f} samples/s (median of {reps}: {sec * 1e3:.3f} ms; "
        f"min {secs[0] * 1e3:.3f}, max {secs[-1] * 1e3:.3f})")
    return n / sec


def slice_phase(dev, record):
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import fused_dynamics_vjp
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import fused_solve_rk4
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    solver = SolverConfig(method="rk4", gradient="backprop", fixed_steps=STEPS)
    icnf = cnf.ICNF.create(nvariables=2, solver=solver, fused=True)
    plain = cnf.ICNF.create(nvariables=2, solver=solver, fused=False)
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    def calls(model):
        return [
            ("TEST logpdf", Mode.TEST, lambda: cnf.ICNFDist(model, params, Mode.TEST).logpdf(x)),
            ("TRAIN logpdf", Mode.TRAIN,
             lambda: cnf.ICNFDist(model, params, Mode.TRAIN, gen(2)).logpdf(x)),
            ("TRAIN_NOREG logpdf", Mode.TRAIN_NOREG,
             lambda: cnf.ICNFDist(model, params, Mode.TRAIN_NOREG, gen(3)).logpdf(x)),
            ("TRAIN sample_with_logpdf", Mode.TRAIN,
             lambda: cnf.ICNFDist(model, params, Mode.TRAIN, gen(4)).sample_with_logpdf(
                 n=BATCH)),
            ("TRAIN sample trace_free", Mode.TRAIN,
             lambda: cnf.ICNFDist(model, params, Mode.TRAIN, gen(5)).sample(
                 BATCH, trace_free=True)),
            ("TRAIN loss", Mode.TRAIN, lambda: cnf.loss(model, Mode.TRAIN, x, params, gen(6))),
        ]

    # launches each call must make: K3 for the whole-solve route, K1 x 4 x steps
    want = {"TRAIN logpdf": (1, 0), "TRAIN_NOREG logpdf": (0, 4 * STEPS),
            "TRAIN sample_with_logpdf": (1, 0), "TRAIN loss": (1, 0)}
    with torch.no_grad():
        # the counted run of the main path: each call once
        fused_solve_rk4.launches = 0
        fused_dynamics_vjp.launches = 0
        outs = {}
        for name, _mode, fn in calls(icnf):
            k3, k1 = fused_solve_rk4.launches, fused_dynamics_vjp.launches
            outs[name] = fn()
            moved = (fused_solve_rk4.launches - k3, fused_dynamics_vjp.launches - k1)
            if moved != want.get(name, (0, 0)):
                fail(f"{name}: kernel launches (K3, K1) = {moved}, expected "
                     f"{want.get(name, (0, 0))}")
        torch.cuda.synchronize()
        launches = {"K3": fused_solve_rk4.launches, "K1": fused_dynamics_vjp.launches}
        log(f"  launches on the main path: {launches}")
        if launches["K3"] == 0 or launches["K1"] == 0:
            fail("a kernel of the path was not launched")
        rates = {name: samples_per_s(name, fn, BATCH) for name, _mode, fn in calls(icnf)}

        # shapes and finiteness
        for name, out in outs.items():
            parts = out if isinstance(out, tuple) else (out,)
            for p in parts:
                if not torch.isfinite(p).all():
                    fail(f"{name}: non-finite output")
        for name in ("TEST logpdf", "TRAIN logpdf", "TRAIN_NOREG logpdf"):
            if outs[name].shape != (BATCH,):
                fail(f"{name}: shape {tuple(outs[name].shape)}")
        s, lp = outs["TRAIN sample_with_logpdf"]
        if s.shape != (BATCH, 2) or lp.shape != (BATCH,):
            fail("sample_with_logpdf shapes")
        if outs["TRAIN sample trace_free"].shape != (BATCH, 2) or outs["TRAIN loss"].ndim != 0:
            fail("sample / loss shapes")

        # the kernel-routed calls again without the kernels, same seeds
        errs = {}
        for name, _mode, fn in calls(plain):
            if name not in want:
                continue
            ref = fn()
            rates[f"{name} (fused=False)"] = samples_per_s(f"{name} (fused=False)", fn, BATCH)
            got = outs[name]
            if name == "TRAIN sample_with_logpdf":
                got, ref = list(got), list(ref)
            errs[name] = compare(f"fused vs unfused: {name}", got, ref, *SLICE_TOL)

        # the exact-trace path on the card against the same model on the CPU
        small = x[:256].cpu()
        params_cpu = {k: v.cpu() for k, v in params.items()}
        cpu_lp = cnf.ICNFDist(icnf, params_cpu, Mode.TEST).logpdf(small)
        compare("TEST logpdf card vs CPU (256 points)", outs["TEST logpdf"][:256].cpu(),
                cpu_lp, *SLICE_TOL)
        log(f"  TEST mean logpx {float(outs['TEST logpdf'].mean()):.4f}, "
            f"TRAIN loss {float(outs['TRAIN loss']):.4f}")

    record["slice"] = dict(samples_per_s=rates, launches=launches, fused_vs_unfused=errs)
    return launches


def train_phase(dev, record):
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
        fused_dynamics_vjp, fused_dynamics_vjp_bwd)
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
        fused_solve_rk4, fused_solve_rk4_bwd)
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    counters = {"K1": fused_dynamics_vjp, "K2": fused_dynamics_vjp_bwd,
                "K3": fused_solve_rk4, "K4": fused_solve_rk4_bwd}

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    solver = SolverConfig(method="rk4", gradient="backprop", fixed_steps=STEPS)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), TRAIN_POINTS)
    ffjord = dict(naugments=0, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0)

    def fit(name, icnf, data, epochs, want):
        """One fit, counted: the launch counts of every step must be ``want``;
        returns (result, launches over the fit, train-step samples/s)."""
        marks = []

        def on_step(_it, _loss):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), counts()))

        params = icnf.init(torch.Generator().manual_seed(0), device=dev)
        model = cnf.ICNFModel(icnf, batchsize=BATCH, epochs=epochs, log_every=1,
                              callback=on_step, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(7))
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), counts()))
        res = model.fit(data, params=params)
        launches = counts()
        for i in range(1, len(marks)):
            step = {k: marks[i][1][k] - marks[i - 1][1][k] for k in counters}
            if step != want:
                fail(f"{name}: step {i - 1} launched {step}, expected {want}")
        hist = res.history
        if res.stats["iterations"] != len(marks) - 1 or not all(map(math.isfinite, hist)):
            fail(f"{name}: {res.stats['iterations']} steps, loss history {hist}")
        # host clock between the ends of consecutive steps (each ends in a synchronize)
        secs = sorted(b[0] - a[0] for a, b in zip(marks[1:], marks[2:]))
        if len(secs) < 5:
            fail(f"{name}: {len(secs)} timed steps, need at least 5")
        rate = BATCH / secs[len(secs) // 2]
        log(f"  {name}: {res.stats['iterations']} steps, launches {launches} "
            f"(per step {want}) ok; loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
            f"{rate:.1f} train samples/s (median of {len(secs)} steps: "
            f"{secs[len(secs) // 2] * 1e3:.3f} ms; min {secs[0] * 1e3:.3f}, "
            f"max {secs[-1] * 1e3:.3f})")
        log(f"    loss history: {[round(v, 4) for v in hist]}")
        return res, launches, rate

    def grads(icnf, params, seed):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        loss = cnf.loss(icnf, Mode.TRAIN, x[:BATCH], p, torch.Generator(device=dev).manual_seed(seed))
        return list(torch.autograd.grad(loss, list(p.values())))

    out = {}
    none = {k: 0 for k in counters}
    for form, kw, epochs, want in (
        ("flagship RNODE", {}, TRAIN_EPOCHS, dict(none, K3=1, K4=1)),
        # remat: each step's K1 launches run again in the backward
        ("FFJORD form", ffjord, 2, dict(none, K1=8 * STEPS, K2=4 * STEPS)),
    ):
        fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True, **kw)
        plain = cnf.ICNF.create(nvariables=2, solver=solver, fused=False, **kw)
        res, launches, rate = fit(f"{form} fused=True", fused, x, epochs, want)
        if form == "flagship RNODE" and not res.history[-1] < res.history[0]:
            fail(f"{form}: the loss did not fall ({res.history[0]} -> {res.history[-1]})")
        _res, _l, rate_plain = fit(f"{form} fused=False", plain, x, 2, none)
        err = compare_to_max(f"{form}: one step's parameter gradients, fused vs unfused",
                             grads(fused, res.params, 11), grads(plain, res.params, 11),
                             GRAD_TOL)
        out[form] = dict(launches=launches, steps=res.stats["iterations"],
                         history=res.history, train_samples_per_s=rate,
                         train_samples_per_s_unfused=rate_plain, grad_max_abs_err=err)
    record["train"] = out
    return {"rnode": out["flagship RNODE"]["launches"], "ffjord": out["FFJORD form"]["launches"]}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"nvidia_smi": card, "device": torch.cuda.get_device_name(0)}

    from continuousnormalizingflows_tpu_torch.ops import _build

    _build.kernels()
    info = _build.build_info
    log(f"[build] {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    record["build_seconds"] = info["seconds"]

    log("[kernels] each kernel vs its plain PyTorch version")
    results = kernel_phase(dev, record)
    log("[slice] flagship RNODE, fused=True, 65,536 samples, rk4-32")
    launches = slice_phase(dev, record)
    log("[train] ICNFModel.fit, batch 65,536, rk4-32: the flagship RNODE (K3 + K4) and "
        "its FFJORD form (K1 + K2)")
    train = train_phase(dev, record)
    for path, want in (("rnode", ("K3", "K4")), ("ffjord", ("K1", "K2"))):
        if any(train[path][k] == 0 for k in want):
            fail(f"train {path}: a kernel of the path was not launched: {train[path]}")

    flag = {r["precision"]: r for r in results if r["shape"] == "flagship"}["fp32"]
    kernels = [
        dict(name="fused_dynamics_fwd", route="cuda",
             source="continuousnormalizingflows_tpu_torch/csrc/fused_dynamics.cu",
             replaces="continuousnormalizingflows_tpu/ops/pallas_kernels.py:118",
             launches=launches["K1"], max_abs_err=flag["k1_max_abs_err"],
             ms=flag["k1"], plain_ms=flag["k1_plain"]),
        dict(name="fused_solve_rk4_fwd", route="cuda",
             source="continuousnormalizingflows_tpu_torch/csrc/fused_solve.cu",
             replaces="continuousnormalizingflows_tpu/ops/pallas_solve.py:176",
             launches=launches["K3"], max_abs_err=flag["k3_max_abs_err"],
             ms=flag["k3"], plain_ms=flag["k3_plain"]),
        dict(name="fused_dynamics_bwd", route="cuda",
             source="continuousnormalizingflows_tpu_torch/csrc/fused_dynamics_bwd.cu",
             replaces="continuousnormalizingflows_tpu/ops/pallas_kernels.py:182",
             launches=train["ffjord"]["K2"], max_abs_err=flag["k2_max_abs_err"],
             ms=flag["k2"], plain_ms=flag["k2_plain"]),
        dict(name="fused_solve_rk4_bwd", route="cuda",
             source="continuousnormalizingflows_tpu_torch/csrc/fused_solve_bwd.cu",
             replaces="continuousnormalizingflows_tpu/ops/pallas_solve.py:206",
             launches=train["rnode"]["K4"], max_abs_err=flag["k4_max_abs_err"],
             ms=flag["k4"], plain_ms=flag["k4_plain"]),
    ]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
