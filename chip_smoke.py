"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``continuousnormalizingflows_tpu_torch/csrc``,
holds each against its plain PyTorch version at the slice's shapes in both
precisions, then drives the flagship RNODE's log-density and sampling path
(65,536 samples) through the public entry points and checks that the
kernels carried it.  Imports nothing of JAX.  Exits non-zero, with no result
line, when there is no CUDA device or any phase fails; on success the last
line is ``{"ok": true, "device": {...}}``.  A detailed record goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = 65_536
STEPS = 32
TABULAR_BATCH = 8_192

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


def kernel_phase(dev, record):
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
        fused_dynamics_vjp, mlp3_forward_vjp_reference)
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
        fused_solve_rk4, fused_solve_rk4_reference)

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
        for kname, sd in (("K1", 0), ("K3", nz + 3)):
            rows, staged, h_pad = _build.plan(n_in, h, nz, nz, sd)
            path = f"row per thread, h padded to {h_pad}" if h_pad else "tiled"
            log(f"  plan {kname} {shape}: {path}, {rows} rows/block, weights in smem: {staged}")
        for cdt in (None, torch.bfloat16):
            prec = "fp32" if cdt is None else "bf16"
            stage = lambda: fused_dynamics_vjp(x, eps, params, nz, cdt)
            stage_ref = lambda: mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
            solve = lambda: fused_solve_rk4(u0, eps, None, params, span, nz, nz, STEPS, cdt)
            solve_ref = lambda: fused_solve_rk4_reference(u0, eps, None, params, span, nz, nz,
                                                         STEPS, cdt)
            err1 = compare(f"K1 fused_dynamics {shape} {prec} B={b}", stage(), stage_ref(),
                           *TOL[("stage", cdt)])
            err3 = compare(f"K3 fused_solve_rk4 {shape} {prec} B={b} steps={STEPS}", solve(),
                           solve_ref(), *TOL[("solve", cdt)])
            # plain, kernel, kernel, plain: the two versions in turns
            t = {"k1_plain": [], "k1": [], "k3_plain": [], "k3": []}
            for order in (("plain", "kernel"), ("kernel", "plain")):
                for which in order:
                    if which == "plain":
                        t["k1_plain"].append(median_ms(stage_ref, 10))
                        t["k3_plain"].append(median_ms(solve_ref, 3))
                    else:
                        t["k1"].append(median_ms(stage, 20))
                        t["k3"].append(median_ms(solve, 10))
            ms = {k: statistics.median(v) for k, v in t.items()}
            log(f"  time {shape} {prec}: K1 {ms['k1']:.4f} ms vs plain {ms['k1_plain']:.4f} ms; "
                f"K3 {ms['k3']:.4f} ms vs plain {ms['k3_plain']:.4f} ms")
            results.append(dict(shape=shape, precision=prec, batch=b, widths=[n_in, h, h, nz],
                                k1_max_abs_err=err1, k3_max_abs_err=err3, **ms))
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
