"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``continuousnormalizingflows_tpu_torch/csrc``,
holds each (forward K1, K3, K5 and backward K2, K4, K6) against its plain
PyTorch version at the flagship and a wide shape, drives the flagship
RNODE's log-density and sampling path (65,536 samples) through the public
entry points, trains it with ``ICNFModel.fit`` (batch 65,536, 32 steps
through K3 + K4) and its FFJORD form (through K1 + K2), runs the
reference-default adaptive stack (dopri5 at 1e-4, the HNW start, the
backsolve and quadrature adjoints, the carried start) on the same model and
batch, the opt-in adaptive whole-solve route (K5 + K6), the reference's
default stack (abm with the quadrature adjoint, unfused and through K1 +
K2), the rest of the model surface (the planar net, the exact sweep,
the Hutchinson JVP, a CondLayer, a from_torch net, custom distributions)
and the utils layer on the image-scale FFJORD path at full width (d = 784,
h = 1024, batch 256, through K1 + K2, both on their wide paths; StepTimer,
profiling.trace, an AsyncCheckpointer save during the fit, the exported
dopri5 eval) and the
digits-shaped path (d = 64, h = 256, through K3 + K4, random_shift_images,
the exported sampler), the rest of the serving export ([export]: the
digits-shaped model fitted on the reference's default stack, abm with the
quadrature adjoint, through K1 + K2, and its abm eval served from a saved
artifact; the written-out exact sweep; a Student-t sampler;
``export_logpdf(mesh=)`` on an NCCL world of 1 and on 2 gloo ranks), then
the parallel layer ([parallel]: a world of 1 on
NCCL, whose ``ICNFModel(mesh=)`` digits fit must give the unsharded fit's
bits through K3 + K4, and 2 gloo ranks spawned on the one card, whose
sharded digits fit, default adaptive stack and K5 + K6 step must agree
with one process), then the model axis in full ([model axis]: 2 gloo ranks
with the digits-shaped net split 128 + 128 on the default stack without the
seminorm through K1 + K2, the 2-probe rk4 step and the TEST exact sweep
split over ``model``, each against one process; ``dryrun_multichip(4)``; a
float64 ``fused=True`` call launching no kernel; ``usage.py``), then
``layout="feature_first"`` ([layout]: the JAX package's
``benchmarks/layout_ab.py``, the flagship's train steps at batch 65,536 in
both layouts and precisions, in turns, with no kernel; the default stack's
steps in both layouts; the exported feature-first and ``from_torch`` exact
TEST log-densities against eager), and checks that the kernels carried
each path.  The
kernels line (third from last) gives each kernel's bound: the least time
the card could take for its work, fp32 FMAs at the published peak or bytes
at the memory rate (bf16 rows: at the bf16 tensor-core peak); K2 and K1
have two more entries there, their wide paths at the image fit's widths and
at the digits widths in bf16, with the launches of the image fit and of
[export]'s default-stack digits fit.  Imports nothing of JAX.  Exits non-zero,
with no result line, when there is no CUDA device or any phase fails; on success
the last line is ``{"ok": true, "device": {...}}``.  A detailed record of
every phase is written as ``chiprun_out/chip_smoke.json``, and everything
printed (the compiler's register and spill counts of every kernel
included) as ``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = 65_536
STEPS = 32
TABULAR_BATCH = 8_192
WIDE_BATCH = 8_192  # K5/K6 at h = 128: 64 control groups
# the JAX package's adaptive band (benchmarks/adaptive_band.py, "h=128 d=20"):
# its batches, its timed steps, and the bound on fused vs unfused losses
BAND_NVARIABLES, BAND_HIDDEN = 20, 128
BAND_BATCHES = (16_384, 65_536)
BAND_STEPS = 10
BAND_LOSS_RTOL = 1e-3
BAND_CHECK_BATCH = 2_048  # the band's widths held to the plain versions (adaptive_kernel_phase)
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
# the same fp32 32-step solve and its exact backward (or the same adaptive
# solve and its backsolve adjoint, each stage and its VJP through K1/K2), by
# hand in one and by autograd in the other, summed over 65,536 rows
GRAD_TOL = 5e-4
# K5/K6 vs their plain versions, per control group of 128 rows: a group whose
# accept decision sits within rounding of the threshold may take another
# step sequence (and move by O(tol)), so step statistics are compared first
# and at most one group in 16 may differ; then the groups whose statistics
# agree: u1 rtol 2e-4 / atol 2e-5 (a few fp32 dopri5 steps, sums in another
# order), the backward per tensor to 5e-4 of its largest entry (as K4)
ADAPTIVE_TOL = (2e-4, 2e-5)
ADAPTIVE_BWD_TOL = 5e-4
# K6 on the cluster path vs the tiled path, per tensor as for BWD_TOL: the
# same arithmetic per row, the weight gradient summed over the rows in
# another grouping (tests/test_torch_kernels_cuda.py
# test_cluster_path_matches_plain_and_tiled)
CLUSTER_BWD_TOL = 1e-5
ADAPTIVE_SCFG = (1e-4, 1e-4, 0.01, 0.9, 0.2, 10.0, 16_384)  # the JAX kernel's controller
SURVEY_SEEDS = (1, 2, 3, 4, 5)  # draws on which K5 and its plain version count their steps
# one step's gradients, the fused adaptive route (exact discrete backward of
# per-group steps) vs the unfused backsolve adjoint (global steps), both at
# rtol = atol = 1e-6: two discretizations of one sensitivity, O(tol) apart
ADAPTIVE_GRAD_TOL = 1e-3
# bench.py's abm + quadrature row: the reference's VCABM with QuadratureAdjoint
ABM_SOLVER = dict(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature")
# the [image] phase: benchmarks/image_bitsdim.py's and digits_bitsdim.py's
# side, width, batch and rk4 steps; the fits' steps (the first untimed, the
# rest timed by StepTimer but for the image fit's last, which runs under
# profiling.trace) and their data points (one epoch)
IMAGE_SIDE, IMAGE_HIDDEN = 28, 1024
DIGITS_SIDE, DIGITS_HIDDEN = 8, 256
IMAGE_BATCH = 256
IMAGE_RK4_STEPS = 24
IMAGE_FIT_STEPS = 16
IMAGE_POINTS = IMAGE_FIT_STEPS * IMAGE_BATCH
# the exported log-density against the eager call on the card: the same
# operations, captured (equal steps asked for too)
EXPORT_RTOL = 1e-5
# [export]: the digits-shaped fit's steps on the reference's default stack,
# the points each part serves, the ranks of its gloo mesh and their
# log-densities' tolerance against one process's (each rank sums its rows'
# error-norm squares, then the ranks' sums are added)
EXPORT_FIT_STEPS = 4
EXPORT_POINTS = 256
EXPORT_RANKS = 2
EXPORT_MESH_RTOL = 1e-5
# [parallel]: the 2-rank digits fit's steps, and its tolerances against one
# process (the bf16 kernels sum each rank's 128 rows, then the ranks' sums)
PARALLEL_RANK_STEPS = 4
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_PARAM_TOL = 1e-3
PARALLEL_JOIN_S = 240
# [model axis]: the digits-shaped net split over 2 model ranks on the card
# (a 1 x 2 mesh of gloo ranks, h = 256 split 128 + 128), held against one
# process on the same 256 points and draws; the tensor-parallel steps timed
# MODEL_AXIS_REPS times after the counted one; the TEST sweep's chunk of
# basis rows and its log-density's (rtol, atol) (each rank sums its rows'
# trace, then the ranks' sums are added; JAX's sweep-axis tolerance);
# usage.py's epochs; the dryrun's ranks
MODEL_AXIS_RANKS = 2
MODEL_AXIS_REPS = 3
MODEL_AXIS_SWEEP_CHUNK = 8
MODEL_AXIS_SWEEP_TOL = (1e-5, 1e-6)
MODEL_AXIS_USAGE_EPOCHS = 4
DRYRUN_RANKS = 4
# [layout]: the JAX package's benchmarks/layout_ab.py (the flagship, rk4-32
# backprop, B = 65,536, Adam at 1e-3) in both layouts and precisions: timed
# train steps a layout (after one warm-up step), in turns; a feature-first
# loss against the batch-first one (JAX's tests/test_core.py:97 bound) and
# the first step's gradients (1e-3 of each tensor's largest, JAX's bound);
# the exported feature-first and from_torch TEST log-densities against eager
LAYOUTS = ("batch_first", "feature_first")
LAYOUT_STEPS = 7
LAYOUT_LOSS_ATOL = 1e-4
LAYOUT_GRAD_TOL = 1e-3
LAYOUT_EXPORT_RTOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet, at a 700 W limit):
# fp32 outside the tensor cores, bf16 dense on the tensor cores, and HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def stage_fmas(n_in: int, h: int, nz: int) -> int:
    """FMAs of one stage forward per row (n_out = nz): the three layers, then
    the probe VJP u2 = A3^T eps, u1 = A2^T d2, e_z = (A1^T d1)[:nz]."""
    return n_in * h + h * h + h * nz + nz * h + h * h + h * nz


def stage_bwd_fmas(n_in: int, h: int, nz: int, nxb: int) -> int:
    """FMAs (and bias adds) of one stage backward per row: the six products
    (d1bar, d2bar, epsbar, z2_t, z1_t, xbar[:nxb]) and the weight gradients'
    outer products and bias sums."""
    products = nz * h + h * h + h * nz + nz * h + h * h + h * nxb
    wgrads = h * n_in + h * nz + 2 * h * h + 2 * nz * h + 2 * h + nz
    return products + wgrads


def param_count(n_in: int, h: int, nz: int) -> int:
    return h * n_in + h + h * h + h + nz * h + nz


def solve_fmas(n_in: int, h: int, nz: int, stages: float, backward: bool) -> float:
    """FMAs per row of ``stages`` stage forwards inside one solve (and, with
    ``backward``, their backwards).  eps is fixed over a solve, so a row
    needs u2 = A3^T eps once, and the backward's two terms linear in u2bar
    (epsbar += u2bar A3^T, dA3 += eps^T u2bar) once, on the sum of u2bar over
    the stages: h adds a stage (an issue slot each, as an FMA)."""
    fmas = stages * (stage_fmas(n_in, h, nz) - h * nz) + h * nz
    if backward:
        fmas += stages * (stage_bwd_fmas(n_in, h, nz, nz) - 2 * h * nz + h) + 2 * h * nz
    return fmas


def kernel_bounds(n_in, h, nz, b, nfe_rows=0, accepted_rows=0, steps=STEPS, cdt=None):
    """Each kernel's (bound_ms, bound_by) on these inputs: K1/K2 one stage of
    b rows, K3/K4 a ``steps``-step rk4 solve (4 stage forwards, and for K4 4
    backwards, a step: what the function needs, not the recompute), K5 the
    stage forwards of the trial steps these inputs took (nfe_rows: NFE x rows
    summed over the control groups), K6 the six stage forwards and backwards
    of each accepted step (accepted_rows).  Floats: the inputs read once,
    the outputs written once, the weights and their gradients.  The
    operations run at the peak of the compute precision ``cdt``: bf16 on
    the tensor cores, fp32 (None) outside them."""
    sd, P = nz + 3, param_count(n_in, h, nz)
    fwd = stage_fmas(n_in, h, nz)
    peak = BF16_FLOPS if cdt == torch.bfloat16 else FP32_FLOPS
    return {
        "K1": bound(b * fwd, b * (n_in + nz + 2 * nz + 3) + P, peak),
        "K2": bound(b * (fwd + stage_bwd_fmas(n_in, h, nz, n_in)),
                    b * (n_in + nz + 2 * nz + 3 + n_in + nz) + 2 * P, peak),
        "K3": bound(b * solve_fmas(n_in, h, nz, steps * 4, False), b * (2 * sd + nz) + P,
                    peak),
        "K4": bound(b * solve_fmas(n_in, h, nz, steps * 4, True),
                    b * (3 * sd + 2 * nz) + 2 * P, peak),
        "K5": bound(b * solve_fmas(n_in, h, nz, nfe_rows / b, False), b * (2 * sd + nz) + P,
                    peak),
        "K6": bound(b * solve_fmas(n_in, h, nz, 6 * accepted_rows / b, True),
                    b * (3 * sd + 2 * nz) + 2 * P, peak),
    }


def bound(fmas: float, floats: float, peak: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over ``peak``
    (2 FLOP an FMA) and the bytes (4 a float, each read or written once)
    over the memory rate."""
    ops_ms, bytes_ms = 2 * fmas / peak * 1e3, 4 * floats / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fwd_path(plan) -> str:
    """K1's plan (``_build.fwd_plan``) in words."""
    return {"row": f"row per thread, h padded to {plan.H}, {plan.rows} threads/block",
            "wide": f"wide, {plan.rows}-row output tiles, {plan.scratch} scratch floats",
            "tiled": f"tiled, {plan.rows} rows/block"}[plan.path]


def bwd_path(plan) -> str:
    """A backward kernel's plan (``_build.bwd_plan``) in words."""
    return {"row": f"row per thread, h padded to {plan.H}, {plan.rows} threads/block",
            "wide": f"wide, {plan.rows}-row output tiles, {plan.scratch} scratch floats",
            "tiled": f"tiled, {plan.rows} rows/tile"}[plan.path]


LOG_LINES: list = []  # everything logged, also written to chiprun_out/chip_smoke.log


def log(msg: str) -> None:
    print(msg, flush=True)
    LOG_LINES.append(msg)


def write_log() -> None:
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG_LINES) + "\n")


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    write_log()
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    fused_solve_rk4_bwd_rows<24, 0> (H = 24, fp32): the identifier after the
    source file's anonymous namespace, found after the namespace's
    ``_cu_<8 hex digits>`` ending or, where nvcc ends it otherwise
    (``..._fused_solve_cu_cnf_plan``), by the namespace's length prefix."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m:
        begin = m.end()
        start = begin + int(m.group(1))
    else:
        m = re.search(r"(\d+)(_GLOBAL__N_)", mangled)
        n = m and re.match(r"\d+", mangled[m.start(2) + int(m.group(1)):])
        if not n:
            return mangled[:72]
        begin = m.start(2) + int(m.group(1)) + n.end()
        start = begin + int(n.group())
    name = mangled[begin:start]
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start:])
    return name + (f"<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>" if args else "")


def ptxas_usage(log: str) -> dict:
    """{kernel label: {"registers", "spill_stores", "spill_loads"}} from the
    ptxas lines of a build log (empty when an earlier process built the
    library)."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = kernel_label(m.group(1))
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(props, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def resident_blocks(regs: int, threads: int, smem: int):
    """Blocks an SM of an H100 holds of a kernel with ``regs`` registers a
    thread, ``threads`` a block and ``smem`` bytes of shared memory: (blocks,
    what the registers allow, what the shared memory allows).  65,536
    registers an SM, given out 256 a warp at a time; 228 KB of shared memory,
    1 KB of it reserved a block; 64 warps and 32 blocks at most."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-regs * 32 // 256) * 256 * warps) if regs else 0
    by_smem = 228 * 1024 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32), by_regs, by_smem


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


def spread_ms(name: str, fn, reps: int, calls: int = 5):
    """``calls`` separate timed calls of :func:`median_ms`: how far a kernel's
    time moves between measurements of the same code on the same card."""
    times = sorted(median_ms(fn, reps) for _ in range(calls))
    log(f"  spread {name}: {calls} timed calls of {reps} launches each, median ms min "
        f"{times[0]:.4f}, median {times[calls // 2]:.4f}, max {times[-1]:.4f}")
    return times


def clocks_under_load(fn, launches: int) -> str:
    """The SM clock and power draw ``nvidia-smi`` reads while ``launches``
    calls of ``fn`` are queued on the card."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


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


def in_turns(pairs):
    """Median ms of each kernel and its plain version, timed in turns (plain,
    kernel, kernel, plain): ``pairs`` maps a name to (kernel, plain, kernel
    reps, plain reps); returns {name: ms, name + "_plain": ms}."""
    t = {k + s: [] for k in pairs for s in ("", "_plain")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            for k, (kern, plain, reps_k, reps_p) in pairs.items():
                if which == "plain":
                    t[k + "_plain"].append(median_ms(plain, reps_p))
                else:
                    t[k].append(median_ms(kern, reps_k))
    return {k: statistics.median(v) for k, v in t.items()}


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
        k1 = _build.fwd_plan(n_in, h, nz, nz, b)
        log(f"  plan K1 {shape}: {fwd_path(k1)}, weights in smem: {k1.staged}")
        k3 = _build.plan(n_in, h, nz, nz, nz + 3, b)
        log(f"  plan K3 {shape}: {fwd_path(k3)}, weights in smem: {k3.staged}")
        for kname, sd in (("K2", 0), ("K4", nz + 3)):
            plan = _build.bwd_plan(n_in, h, nz, nz, sd, b)
            log(f"  plan {kname} {shape}: {bwd_path(plan)}, grid {plan.grid}, "
                f"{plan.n_params} params, weights in smem: {plan.staged}")
            record.setdefault("bwd_plans", {})[f"{kname} {shape}"] = dict(
                path=plan.path, H=plan.H, rows=plan.rows, grid=plan.grid)
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
            ms = in_turns(pairs)
            log(f"  time {shape} {prec}: " + "; ".join(
                f"{k.upper()} {ms[k]:.4f} ms vs plain {ms[k + '_plain']:.4f} ms" for k in pairs))
            # K4's rate: the work the function needs (its bound's) and the
            # work as designed (the trajectory and the k1..k3 recompute: 11
            # stage forwards and 4 backwards a step; the row path keeps u2
            # for the 4 forwards before the backwards; the wide path's
            # trajectory and recompute, 7 a step but 4 once, compute y only,
            # and it takes the terms of eps once)
            fwd, bwd = stage_fmas(n_in, h, nz), stage_bwd_fmas(n_in, h, nz, nz)
            need = 2 * b * solve_fmas(n_in, h, nz, STEPS * 4, True)
            k4_path = record["bwd_plans"][f"K4 {shape}"]["path"]
            if k4_path == "row":
                done = 2 * b * (STEPS * (11 * fwd - 4 * h * nz + 4 * bwd) + h * nz)
            elif k4_path == "wide":
                y_only = n_in * h + h * h + h * nz
                done = 2 * b * ((7 * STEPS - 4) * y_only
                                + 4 * STEPS * (fwd + bwd - 3 * h * nz) + 3 * h * nz)
            else:
                done = 2 * b * STEPS * (11 * fwd + 4 * bwd)
            k4_bound = kernel_bounds(n_in, h, nz, b, cdt=cdt)["K4"][0]
            log(f"  K4 {shape} {prec}: {need / ms['k4'] / 1e6:.1f} GFLOP/s of needed work "
                f"({need / 1e9:.1f} GFLOP), {done / ms['k4'] / 1e6:.1f} GFLOP/s as designed "
                f"({done / 1e9:.1f} GFLOP); {k4_bound / ms['k4'] * 100:.2f} % of its "
                f"{k4_bound:.4f} ms {prec} bound")
            if shape == "flagship" and cdt is None:
                record["spread_ms"] = dict(k2=spread_ms("K2 flagship fp32", stage_bwd, 20),
                                           k4=spread_ms("K4 flagship fp32", solve_bwd, 3))
                record["under_load"] = clocks_under_load(solve_bwd, 40)
                log("  nvidia-smi with 40 K4 launches queued (clocks.sm, power.draw, "
                    f"power.limit, temperature): {record['under_load']}")
            results.append(dict(shape=shape, precision=prec, batch=b, widths=[n_in, h, h, nz],
                                k1_max_abs_err=err1, k2_max_abs_err=err2, k3_max_abs_err=err3,
                                k4_max_abs_err=err4, **ms))
    record["kernels_vs_plain"] = results
    record["k2_ffjord_widths"] = ffjord_stage_phase(dev)
    record["image_path_widths"] = image_widths_phase(dev)
    return results


def ffjord_stage_phase(dev):
    """K1 and K2 at the widths the FFJORD-form train step launches them at
    (3 -> 12 -> 12 -> 2; on the row path K1 takes H = 12, K2 pads to 16), at
    the flagship batch: against their plain versions, timed, beside their
    bounds."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
        fused_dynamics_vjp, fused_dynamics_vjp_bwd, fused_dynamics_vjp_bwd_reference,
        mlp3_forward_vjp_reference)

    n_in, h, nz, b = 3, 12, 2, BATCH
    params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    cot = (torch.randn((b, nz), generator=g, device=dev),
           torch.randn((b, nz), generator=g, device=dev),
           *torch.randn((3, b), generator=g, device=dev))
    plan = _build.bwd_plan(n_in, h, nz, nz, 0, b)
    log(f"  plan K2 FFJORD widths: {bwd_path(plan)}, grid {plan.grid}, {plan.n_params} params")
    out = []
    for cdt in (None, torch.bfloat16):
        prec = "fp32" if cdt is None else "bf16"
        bounds = kernel_bounds(n_in, h, nz, b, cdt=cdt)
        k1 = lambda: fused_dynamics_vjp(x, eps, params, nz, cdt)
        k1_ref = lambda: mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
        k2 = lambda: fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
        k2_ref = lambda: fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot, cdt)
        err1 = compare(f"K1 fused_dynamics FFJORD widths {prec} B={b}", k1(), k1_ref(),
                       *TOL[("stage", cdt)])
        err2 = compare_to_max(f"K2 fused_dynamics_bwd FFJORD widths {prec} B={b}", flat(k2()),
                              flat(k2_ref()), BWD_TOL[("stage", cdt)])
        ms = in_turns({"k1": (k1, k1_ref, 20, 10), "k2": (k2, k2_ref, 20, 10)})
        log(f"  time FFJORD widths {prec}: K1 {ms['k1']:.4f} ms vs plain {ms['k1_plain']:.4f} ms "
            f"(bound {bounds['K1'][0]:.4f} ms, {bounds['K1'][1]}); K2 {ms['k2']:.4f} ms vs "
            f"plain {ms['k2_plain']:.4f} ms (bound {bounds['K2'][0]:.4f} ms, {bounds['K2'][1]})")
        out.append(dict(precision=prec, batch=b, widths=[n_in, h, h, nz], k1_max_abs_err=err1,
                        k2_max_abs_err=err2, k1_bound_ms=bounds["K1"][0],
                        k2_bound_ms=bounds["K2"][0], **ms))
    return out


def image_widths_phase(dev):
    """The four kernels of the [image] phase at its widths and batch: K1 and
    K2 at the image model's 785 -> 1024 -> 1024 -> 784, K3 and K4 at the
    digits-shaped 65 -> 256 -> 256 -> 64 (state 67, 24 steps), and K1 and
    K2 at the digits widths too (the default-stack digits fits of [export]
    and [model axis]), B = 256,
    fp32 and bf16: each against its plain version, timed in turns, beside
    its bound; all must take their wide paths there and give the same
    bits twice, and a call must add under 32 MB (K1), 64 MB (K2), 8 MB (K3)
    and 16 MB (K4) to the device's peak memory.  The kernels a call of K3
    and of K4 launches are counted by the profiler.  Beside K1:
    ``torch.matmul`` of the six products of its chain, summed."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
        fused_dynamics_vjp, fused_dynamics_vjp_bwd, fused_dynamics_vjp_bwd_reference,
        mlp3_forward_vjp_reference)
    from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
        fused_solve_rk4, fused_solve_rk4_bwd, fused_solve_rk4_bwd_reference,
        fused_solve_rk4_reference)

    b, steps, out = IMAGE_BATCH, IMAGE_RK4_STEPS, []
    widths = [(shape, side * side + 1, h, side * side) for shape, side, h in (
        ("image", IMAGE_SIDE, IMAGE_HIDDEN), ("digits", DIGITS_SIDE, DIGITS_HIDDEN),
        ("digits_stage", DIGITS_SIDE, DIGITS_HIDDEN))]
    stage_shapes = ("image", "digits_stage")  # K1 and K2; "digits": K3 and K4
    for shape, n_in, h, nz in widths:
        params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((b, n_in), generator=g, device=dev)
        eps = torch.randn((b, nz), generator=g, device=dev)
        u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                        torch.zeros((b, 3), device=dev)], dim=-1)
        cot = (torch.randn((b, nz), generator=g, device=dev),
               torch.randn((b, nz), generator=g, device=dev),
               *torch.randn((3, b), generator=g, device=dev))
        gbar = torch.randn((b, nz + 3), generator=g, device=dev)
        span = (0.0, 1.0)
        if shape in stage_shapes:
            ks = ("K1", "K2")
            plans = [("K1", _build.fwd_plan(n_in, h, nz, nz, b)),
                     ("K2", _build.bwd_plan(n_in, h, nz, nz, 0, b))]
        else:
            ks = ("K3", "K4")
            plans = [("K3", _build.plan(n_in, h, nz, nz, nz + 3, b)),
                     ("K4", _build.bwd_plan(n_in, h, nz, nz, nz + 3, b))]
        for kname, plan in plans:
            if plan.path != "wide":
                fail(f"{kname} at the {shape} widths takes the {plan.path} path, not the wide one")
            words = bwd_path(plan) if kname in ("K2", "K4") else fwd_path(plan)
            log(f"  plan {kname} {shape} widths {n_in} -> {h} -> {h} -> {nz}, B={b}: {plan} "
                f"({words})")
        for cdt in (None, torch.bfloat16):
            prec = "fp32" if cdt is None else "bf16"
            bounds = kernel_bounds(n_in, h, nz, b, steps=steps, cdt=cdt)
            if shape in stage_shapes:
                calls = {
                    "k1": (lambda: fused_dynamics_vjp(x, eps, params, nz, cdt),
                           lambda: mlp3_forward_vjp_reference(x, eps, params, nz, cdt), 10, 10),
                    "k2": (lambda: fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt),
                           lambda: fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot,
                                                                    cdt), 5, 5)}
                errs = {"k1": compare(f"K1 fused_dynamics {shape} widths {prec} B={b}",
                                      calls["k1"][0](), calls["k1"][1](), *TOL[("stage", cdt)]),
                        "k2": compare_to_max(f"K2 fused_dynamics_bwd {shape} widths {prec} B={b}",
                                             flat(calls["k2"][0]()), flat(calls["k2"][1]()),
                                             BWD_TOL[("stage", cdt)])}
                peak_mb = {
                    "k1": same_bits_and_peak(dev, lambda: list(calls["k1"][0]()),
                                             f"K1 {shape} widths {prec}", 32.0),
                    "k2": same_bits_and_peak(dev, lambda: flat(calls["k2"][0]()),
                                             f"K2 {shape} widths {prec}", 64.0)}
                lib_ms = products_matmul_ms(dev, b, n_in, h, nz, cdt)
                log(f"  torch.matmul of K1's six products at the {shape} widths, {prec}: "
                    f"{lib_ms:.4f} ms in all")
            else:
                calls = {
                    "k3": (lambda: fused_solve_rk4(u0, eps, None, params, span, nz, nz, steps, cdt),
                           lambda: fused_solve_rk4_reference(u0, eps, None, params, span, nz,
                                                             nz, steps, cdt), 5, 5),
                    "k4": (lambda: fused_solve_rk4_bwd(u0, eps, None, params, span, nz, nz,
                                                       steps, gbar, cdt),
                           lambda: fused_solve_rk4_bwd_reference(u0, eps, None, params, span, nz,
                                                                 nz, steps, gbar, cdt), 3, 3)}
                errs = {"k3": compare(f"K3 fused_solve_rk4 digits widths {prec} B={b} "
                                      f"steps={steps}", calls["k3"][0](), calls["k3"][1](),
                                      *TOL[("solve", cdt)]),
                        "k4": compare_to_max(f"K4 fused_solve_rk4_bwd digits widths {prec} "
                                             f"B={b} steps={steps}", flat(calls["k4"][0]()),
                                             flat(calls["k4"][1]()), BWD_TOL[("solve", cdt)])}
                peak_mb = {
                    "k3": same_bits_and_peak(dev, lambda: [calls["k3"][0]()],
                                             f"K3 digits widths {prec}", 8.0),
                    "k4": same_bits_and_peak(dev, lambda: flat(calls["k4"][0]()),
                                             f"K4 digits widths {prec}", 16.0)}
                per_call = {k: kernels_a_call(calls[k][0]) for k in ("k3", "k4")}
                log(f"  K3 and K4 wide paths at the digits widths, {prec}: {per_call['k3']} and "
                    f"{per_call['k4']} kernels a call")
            ms = in_turns(calls)
            log(f"  time {shape} widths {prec}: " + "; ".join(
                f"{k} {ms[k.lower()]:.4f} ms vs plain {ms[k.lower() + '_plain']:.4f} ms (bound "
                f"{bounds[k][0]:.4f} ms, {bounds[k][1]}: {bounds[k][0] / ms[k.lower()]:.2%} of "
                "it)" for k in ks))
            ms.update({f"{k}_peak_mb": v for k, v in peak_mb.items()})
            if shape in stage_shapes:
                ms.update(k1_products_matmul_ms=lib_ms)
            else:
                ms.update({f"{k}_kernels_a_call": v for k, v in per_call.items()})
            out.append(dict(shape=shape, precision=prec, batch=b, widths=[n_in, h, h, nz],
                            **{f"{k}_max_abs_err": v for k, v in errs.items()},
                            **{f"{k.lower()}_bound_ms": bounds[k][0] for k in ks}, **ms))
    return out


def same_bits_and_peak(dev, fn, name, limit_mb):
    """A kernel's call ``fn`` (returning a list of tensors) gives the same
    bits twice and adds under ``limit_mb`` to the device's peak memory (its
    outputs and scratch); returns the MB it adds."""
    first = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    second = fn()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    if not all(torch.equal(a, c) for a, c in zip(first, second)):
        fail(f"{name}: two calls on the same inputs differ")
    if peak_mb >= limit_mb:
        fail(f"{name}: a call adds {peak_mb:.1f} MB to the device's peak, over {limit_mb} MB")
    log(f"  {name}: two calls give the same bits ok; a call adds {peak_mb:.1f} MB to the "
        f"device's peak memory (under {limit_mb:.0f} MB) ok")
    return peak_mb


def kernels_a_call(fn) -> int:
    """Device kernels that one call of ``fn`` launches (after a first call),
    counted by torch.profiler; copies and memsets are not kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def products_matmul_ms(dev, b, n_in, h, nz, cdt):
    """Median ms of one ``torch.matmul`` of each of K1's six products at
    these widths (x A1^T, h1 A2^T, h2 A3^T, eps A3, d2 A2, d1 A1[:, :nz]) in
    ``cdt``, summed: the library's time for the products K1's wide path
    launches."""
    dt = cdt or torch.float32
    g = torch.Generator(device=dev).manual_seed(4)
    total = 0.0
    for m, k, n in ((b, n_in, h), (b, h, h), (b, h, nz), (b, nz, h), (b, h, h), (b, h, nz)):
        a = torch.randn((m, k), generator=g, device=dev).to(dt)
        w = torch.randn((k, n), generator=g, device=dev).to(dt)
        total += median_ms(lambda: a @ w, 20)
    return total


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
        reset_counts()
        outs = {}
        for name, _mode, fn in calls(icnf):
            k3, k1 = counts()["K3"], counts()["K1"]
            outs[name] = fn()
            moved = (counts()["K3"] - k3, counts()["K1"] - k1)
            if moved != want.get(name, (0, 0)):
                fail(f"{name}: kernel launches (K3, K1) = {moved}, expected "
                     f"{want.get(name, (0, 0))}")
        torch.cuda.synchronize()
        launches = {"K3": counts()["K3"], "K1": counts()["K1"]}
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


def counts():
    """The launch counter of every kernel, by name (``K1`` ... ``K6``)."""
    from continuousnormalizingflows_tpu_torch.utils import profiling

    c = profiling.counters()
    return {k: c.get(f"{k}.launches", 0) for k in KERNELS}


def reset_counts():
    from continuousnormalizingflows_tpu_torch.utils import profiling

    profiling.reset_counters()


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")
NO_LAUNCH = {k: 0 for k in KERNELS}


def timed_fit(name, icnf, data, epochs, want, dev, seed=7):
    """One fit at batch BATCH, counted: the launch counts of every step must
    be ``want`` (or, where ``want`` is a function of a step's counts, make it
    true); returns (result, launches over the fit, train samples/s)."""
    import continuousnormalizingflows_tpu_torch as cnf

    marks = []

    def on_step(_it, _loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), counts()))

    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    model = cnf.ICNFModel(icnf, batchsize=BATCH, epochs=epochs, log_every=1,
                          callback=on_step, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed))
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks.append((time.perf_counter(), counts()))
    res = model.fit(data, params=params)
    launches = counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    expected = " ".join(want.__doc__.split()) if callable(want) else want
    for i in range(1, len(marks)):
        step = {k: marks[i][1][k] - marks[i - 1][1][k] for k in NO_LAUNCH}
        if not (want(step) if callable(want) else step == want):
            fail(f"{name}: step {i - 1} launched {step}, expected {expected}")
    hist = res.history
    if res.stats["iterations"] != len(marks) - 1 or not all(map(math.isfinite, hist)):
        fail(f"{name}: {res.stats['iterations']} steps, loss history {hist}")
    # host clock between the ends of consecutive steps (each ends in a synchronize)
    secs = sorted(b[0] - a[0] for a, b in zip(marks[1:], marks[2:]))
    if len(secs) < 5:
        fail(f"{name}: {len(secs)} timed steps, need at least 5")
    rate = BATCH / secs[len(secs) // 2]
    solver = {k: res.stats[k] for k in ("nfe", "naccept", "nreject")}
    log(f"  {name}: {res.stats['iterations']} steps, launches {launches} "
        f"(per step {expected}) ok; loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
        f"{rate:.1f} train samples/s (median of {len(secs)} steps: "
        f"{secs[len(secs) // 2] * 1e3:.3f} ms; min {secs[0] * 1e3:.3f}, "
        f"max {secs[-1] * 1e3:.3f}); last step's solve {solver}; peak device memory over the "
        f"fit {peak_mib:.1f} MiB")
    log(f"    loss history: {[round(v, 4) for v in hist]}")
    return res, launches, rate


def train_phase(dev, record):
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    solver = SolverConfig(method="rk4", gradient="backprop", fixed_steps=STEPS)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), TRAIN_POINTS)
    ffjord = dict(naugments=0, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0)

    def grads(icnf, params, seed):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        loss = cnf.loss(icnf, Mode.TRAIN, x[:BATCH], p, torch.Generator(device=dev).manual_seed(seed))
        return list(torch.autograd.grad(loss, list(p.values())))

    out = {}
    for form, kw, epochs, want in (
        ("flagship RNODE", {}, TRAIN_EPOCHS, dict(NO_LAUNCH, K3=1, K4=1)),
        # remat: each step's K1 launches run again in the backward
        ("FFJORD form", ffjord, 2, dict(NO_LAUNCH, K1=8 * STEPS, K2=4 * STEPS)),
    ):
        fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True, **kw)
        plain = cnf.ICNF.create(nvariables=2, solver=solver, fused=False, **kw)
        res, launches, rate = timed_fit(f"{form} fused=True", fused, x, epochs, want, dev)
        if form == "flagship RNODE" and not res.history[-1] < res.history[0]:
            fail(f"{form}: the loss did not fall ({res.history[0]} -> {res.history[-1]})")
        _res, _l, rate_plain = timed_fit(f"{form} fused=False", plain, x, 2, NO_LAUNCH, dev)
        err = compare_to_max(f"{form}: one step's parameter gradients, fused vs unfused",
                             grads(fused, res.params, 11), grads(plain, res.params, 11),
                             GRAD_TOL)
        out[form] = dict(launches=launches, steps=res.stats["iterations"],
                         history=res.history, train_samples_per_s=rate,
                         train_samples_per_s_unfused=rate_plain, grad_max_abs_err=err)
    record["train"] = out
    return {"rnode": out["flagship RNODE"]["launches"], "ffjord": out["FFJORD form"]["launches"]}


def adaptive_draws(dev, b, nz, h, seed, spread):
    """Inputs of K5/K6: random init, u0 from N(0, 0.25), probes, the cotangent
    of u1 and a steered t1; with ``spread`` the weights doubled, each 128-row
    group's rows scaled by its own factor of 0.1-10 and the first step half
    the span."""
    from continuousnormalizingflows_tpu_torch.models.nets import MLP

    sd, n_in = nz + 3, nz + 1
    params = MLP((n_in, h, h, nz)).init(torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    eps = torch.randn((b, nz), generator=g, device=dev)
    z0 = 0.5 * torch.randn((b, nz), generator=g, device=dev)
    if spread:
        params = {k: 2.0 * v for k, v in params.items()}
        z0 = z0 * torch.logspace(-1, 1, b // 128, device=dev).repeat_interleave(128)[:, None]
    u0 = torch.cat([z0, torch.zeros((b, 3), device=dev)], dim=-1)
    gbar = torch.randn((b, sd), generator=g, device=dev)
    span = (0.0, torch.tensor(1.05, device=dev))  # steered t1 as a device scalar
    scfg = ADAPTIVE_SCFG[:2] + (0.5,) + ADAPTIVE_SCFG[3:] if spread else ADAPTIVE_SCFG
    return (u0, eps, None, params, span, nz, nz, scfg), gbar


def step_survey(name, dev, b, h, spread, seeds, bound):
    """K5, its plain version and the plain version in float64, on the draws of
    several seeds: per seed, the 128-row groups whose step statistics differ.
    Fails where K5 and the plain version differ in more than ``bound`` of the
    groups.  For ``bound=None`` it also prints group 0's error ratio of every
    trial step in float32 and in float64."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    ratios, inner = [], fa._group_error_ratio
    out = []
    for seed in seeds:
        args, _gbar = adaptive_draws(dev, b, 5, h, seed, spread)
        wide = (args[0].double(), args[1].double(), None,
                {k: v.double() for k, v in args[3].items()}) + args[4:]
        st = fa.fused_solve_dopri5(*args, 64)[1]
        seen = {}
        for prec, a in (("fp32", args), ("fp64", wide)):
            ratios.clear()
            fa._group_error_ratio = lambda *x: ratios.append(inner(*x)) or ratios[-1]
            try:
                seen[prec] = fa.fused_solve_dopri5_reference(*a, 128)[1]
            finally:
                fa._group_error_ratio = inner
            seen[prec + " ratios"] = [f"{float(r[0]):.3e}" for r in ratios]
        differ = lambda x, y: int((x[:, :3] != y[:, :3]).any(dim=1).sum())
        n, n64 = differ(st, seen["fp32"]), differ(seen["fp32"], seen["fp64"])
        nfe = lambda x: f"{int(x[:, 0].min())}-{int(x[:, 0].max())}"
        log(f"  steps {name} seed {seed}: K5 vs plain {n} of {st.shape[0]} groups differ, plain "
            f"fp32 vs fp64 {n64}; NFE K5 {nfe(st)}, plain fp32 {nfe(seen['fp32'])}, fp64 "
            f"{nfe(seen['fp64'])}")
        if bound is None:
            log(f"    group 0's trial error ratios: fp32 {seen['fp32 ratios']}, "
                f"fp64 {seen['fp64 ratios']}")
        elif n > bound * st.shape[0]:
            fail(f"K5 {name} seed {seed}: {n} of {st.shape[0]} groups differ in their steps")
        out.append(dict(seed=seed, groups=st.shape[0], k5_vs_plain=n, fp32_vs_fp64=n64))
    return out


def adaptive_kernel_phase(dev, record):
    """K5 and K6 against their plain versions at the flagship and at h = 128."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    results, surveys = [], {}
    # At the random init the h = 128 field is so smooth that the error ratios
    # of its first trials from the fixed start (dt0 = 0.01 of the span) are
    # float32 rounding (fp32 ~1e-5 against fp64 ~1e-8): whether the third
    # step reaches t1 turns on that rounding in every group alike, and where
    # the step counts agree the step sizes still differ by the rounding of
    # the ratio, so u1 moves by O(tol) ("h128 random init" below).  The
    # compared h = 128 case doubles the weights and starts at half the span,
    # so every ratio is resolved in float32 (fp32 and fp64 within 1e-3), and
    # spreads the groups over draw scales of 0.1-10, so each group takes its
    # own steps and a decision on a rounding edge moves one group, not all.
    # The band: the JAX package's adaptive band's widths (band_model: 42 ->
    # 128 -> 128 -> 41, state 44) on the h = 128 case's draws, held to the
    # plain versions at B = 2,048 (the card tests' size: at 16,384 these
    # draws, up to 73 NFE on 44 columns, put 2-5 of 720,896 elements of u1
    # past ADAPTIVE_TOL of the plain version, fp32 or fp64, in the tiled
    # path's bits too: fp32 order over a long solve, not the cluster path),
    # then at the band's batches ("band16k", "band65k") held to the tiled
    # path (K5's bits, K6 to CLUSTER_BWD_TOL) and timed beside it.  The
    # band's own inputs (band_phase's params and x) are held to the plain
    # versions at both batches in band_phase.  Where K5 and K6 take the
    # cluster path, the parent's tiled path is timed beside it in the same
    # call (fused_adaptive._WIDE_PATH = "tiled").
    band_nz = BAND_NVARIABLES + BAND_NVARIABLES + 1
    shapes = (("flagship", 5, 24, BATCH, False), ("h128", 5, 128, WIDE_BATCH, True),
              ("band", band_nz, BAND_HIDDEN, BAND_CHECK_BATCH, True),
              ("band16k", band_nz, BAND_HIDDEN, BAND_BATCHES[0], True),
              ("band65k", band_nz, BAND_HIDDEN, BAND_BATCHES[1], True))
    for shape, nz, h, b, spread in shapes:
        n_in = nz + 1
        sd = nz + 3
        args, gbar = adaptive_draws(dev, b, nz, h, 1, spread)
        group = fa.fused_adaptive_tile(b)
        H, rows, smem, bwd_rows, smem_bwd, walk_h, walk_blocks = _build.adaptive_plan(
            n_in, h, nz, nz, sd, group)
        cplan = _build.cluster_plan(n_in, h, nz, nz, sd, group, b)
        path = f"row per thread, h padded to {H}" if H else f"tiled, {rows} rows a stage tile"
        walk = (f"row per thread, h padded to {walk_h}, {bwd_rows} threads/block" if walk_h
                else f"tiled, {bwd_rows}-row tiles")
        if cplan.cluster:
            log(f"  plan K5/K6 {shape} ({n_in} -> {h} -> {h} -> {nz}, B={b}): groups of {group} "
                f"rows; {cluster_words(cplan, b)} (the tiled path it replaces: {path}, grid "
                f"{b // group}, {smem} B shared; walk {walk}, {smem_bwd} B shared)")
            record.setdefault("cluster_plans", {})[shape] = cplan._asdict()
        else:
            log(f"  plan K5/K6 {shape}: groups of {group} rows; K5 and K6's replay {path}, grid "
                f"{b // group}, {smem} B shared; K6's walk back {walk}, grid "
                f"{b // group * walk_blocks}, {smem_bwd} B shared")
        usage = ptxas_usage(_build.build_info.get("log", ""))
        for name in ("adaptive_fwd_rows", "adaptive_replay"):
            if not H:
                break
            u = usage.get(f"{name}<{H}>")
            if u is None:
                log(f"  {name}<{H}> {shape}: no ptxas lines (the library was built earlier)")
                continue
            blocks, by_regs, by_smem = resident_blocks(u["registers"], group, smem)
            log(f"  {name}<{H}> {shape}: row path, H = {H}, {u['registers']} registers, spill "
                f"bytes {u.get('spill_stores')} stored / {u.get('spill_loads')} loaded, "
                f"{blocks} resident blocks an SM (registers allow {by_regs}, shared memory "
                f"{by_smem})")
            record.setdefault("adaptive_row_kernels", {})[f"{name}<{H}> {shape}"] = dict(
                u, resident_blocks=blocks)
        record.setdefault("bwd_plans", {})[f"K6 walk {shape}"] = dict(
            path="row" if walk_h else "cluster" if cplan.cluster else "tiled", H=walk_h,
            rows=cplan.walk_rows if cplan.cluster else bwd_rows,
            grid=b // group * (cplan.cluster or walk_blocks))
        k5 = lambda: fa.fused_solve_dopri5(*args, 64)
        if shape in ("band16k", "band65k"):  # the cluster path against the tiled path
            t = {"k5": [], "k6": [], "k5_tiled": [], "k6_tiled": []}
            k6 = lambda: fa.fused_solve_dopri5_bwd(*args, 64, gbar)
            (u1, st), got = k5(), k6()
            fa._WIDE_PATH = "tiled"
            try:
                (u1_t, st_t), want = k5(), k6()
            finally:
                fa._WIDE_PATH = None
            if not (torch.equal(u1.view(torch.int32), u1_t.view(torch.int32))
                    and torch.equal(st, st_t)):
                fail(f"K5 {shape}: the cluster path's u1 or stats differ from the tiled path's "
                     f"bits")
            log(f"  K5 {shape}: the cluster path gives the tiled path's bits in u1 and the "
                f"stats ok")
            if not torch.equal(got[3], want[3]):
                fail(f"K6 {shape}: the cluster path's replay took other steps than the tiled "
                     f"path's")
            compare_to_max(f"K6 {shape} cluster path vs tiled path", [got[0], got[1], *got[2]],
                           [want[0], want[1], *want[2]], CLUSTER_BWD_TOL)
            for wide in (None, "tiled", "tiled", None):
                fa._WIDE_PATH = wide
                try:
                    sfx = "_tiled" if wide else ""
                    t["k5" + sfx].append(median_ms(k5, 3, warmup=1))
                    t["k6" + sfx].append(median_ms(k6, 2, warmup=1))
                finally:
                    fa._WIDE_PATH = None
            ms = {k: statistics.median(v) for k, v in t.items()}
            nfe_rows, accepted_rows = int(st[:, 0].sum()) * group, int(st[:, 1].sum()) * group
            bounds = kernel_bounds(n_in, h, nz, b, nfe_rows, accepted_rows)
            log(f"  time {shape} fp32: " + "; ".join(
                f"{k.upper()} {ms[k]:.4f} ms (tiled path {ms[k + '_tiled']:.4f} ms"
                + (f", plain {ms[k + '_plain']:.4f} ms" if k + "_plain" in ms else "")
                + f", bound {bounds[k.upper()][0]:.4f} ms)" for k in ("k5", "k6")))
            results.append(dict(shape=shape, batch=b, widths=[n_in, h, h, nz],
                                groups=st.shape[0], nfe_rows=nfe_rows,
                                accepted_rows=accepted_rows, nfe_max=int(st[:, 0].max()), **ms))
            continue
        k5_ref = lambda: fa.fused_solve_dopri5_reference(*args, group)
        # At the band's widths (41 state columns, up to 73 NFE on these
        # draws) the plain version in fp32 is itself up to 3.5e-4 from
        # float64 (within ADAPTIVE_TOL of it everywhere), so two fp32 orders
        # can part by twice that: the band's K5 is held to the plain version
        # run in float64 (the same code in u0's dtype), steps and u1, under
        # the same tolerances; plain_ms stays the fp32 plain version's time,
        # and K6 (per tensor, to ADAPTIVE_BWD_TOL of its largest entry) is
        # held to the fp32 plain version.
        ref_args = args
        if shape == "band":
            ref_args = (args[0].double(), args[1].double(), None,
                        {k: v.double() for k, v in args[3].items()}) + args[4:]
        (u1, st), (u1_p, st_p) = k5(), fa.fused_solve_dopri5_reference(*ref_args, group)
        u1_p = u1_p.float()
        same = (st[:, :3] == st_p[:, :3]).all(dim=1)
        n_diff = int((~same).sum())
        log(f"  K5 {shape} B={b}: {n_diff} of {st.shape[0]} groups take other steps than the "
            f"plain version; NFE {int(st[:, 0].min())}-{int(st[:, 0].max())}, accepted "
            f"{int(st[:, 1].min())}-{int(st[:, 1].max())}, rejected {int(st[:, 2].max())} at most")
        if n_diff * 16 > st.shape[0]:
            fail(f"K5 {shape}: {n_diff} of {st.shape[0]} groups differ in their steps")
        again = k5()
        if not all(torch.equal(a.view(torch.int32), c.view(torch.int32))
                   for a, c in zip((u1, st), again)):
            fail(f"K5 {shape}: two calls on the same inputs differ")
        log(f"  K5 {shape}: two calls give the same bits in u1 and the stats ok")
        keep = same.repeat_interleave(group)
        err5 = compare(f"K5 fused_solve_dopri5 {shape} B={b} (groups of equal steps)",
                       u1[keep], u1_p[keep], *ADAPTIVE_TOL)
        # the cotangent is zero on the groups of other steps, so every weight
        # gradient sums over the groups of equal steps only and is compared
        gbar = torch.where(keep[:, None], gbar, torch.zeros_like(gbar))
        k6 = lambda: fa.fused_solve_dopri5_bwd(*args, 64, gbar)
        k6_ref = lambda: fa.fused_solve_dopri5_bwd_reference(*args, 64, gbar, group)
        got, want = k6(), k6_ref()
        if not torch.equal(got[3], st[:, 1].to(torch.int32)):
            fail(f"K6 {shape}: the replay's accepted steps differ from K5's")
        log(f"  K6 {shape}: the replay took K5's accepted steps in every group ok")
        err6 = compare_to_max(f"K6 fused_solve_dopri5_bwd {shape} B={b}",
                              [got[0][keep], got[1][keep], *got[2]],
                              [want[0][keep], want[1][keep], *want[2]], ADAPTIVE_BWD_TOL)
        again = k6()
        if not all(torch.equal(a, c) for a, c in zip((got[0], got[1], *got[2]),
                                                      (again[0], again[1], *again[2]))):
            fail(f"K6 {shape}: two calls on the same inputs differ")
        log(f"  K6 {shape}: two calls give the same bits ok")
        pairs = {"k5": (k5, k5_ref, 10, 3), "k6": (k6, k6_ref, 5, 2)}
        t = {k + sfx: [] for k in pairs for sfx in ("", "_plain")}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                for k, (kern, plain, reps_k, reps_p) in pairs.items():
                    if which == "plain":
                        t[k + "_plain"].append(median_ms(plain, reps_p, warmup=1))
                    else:
                        t[k].append(median_ms(kern, reps_k))
        if cplan.cluster:  # the parent's tiled path on the same inputs, in the same call
            fa._WIDE_PATH = "tiled"
            try:
                tiled = k5(), k6()
                if not torch.equal(tiled[0][0].view(torch.int32), u1.view(torch.int32)):
                    fail(f"K5 {shape}: the cluster path's u1 differs from the tiled path's bits")
                for k, (kern, _plain, reps_k, _reps_p) in pairs.items():
                    t[k + "_tiled"] = [median_ms(kern, max(2, reps_k // 2))]
            finally:
                fa._WIDE_PATH = None
            log(f"  K5 {shape}: the cluster path gives the tiled path's bits in u1 ok")
        ms = {k: statistics.median(v) for k, v in t.items()}
        log(f"  time {shape} fp32: " + "; ".join(
            f"{k.upper()} {ms[k]:.4f} ms vs plain {ms[k + '_plain']:.4f} ms"
            + (f", tiled path {ms[k + '_tiled']:.4f} ms" if k + "_tiled" in ms else "")
            for k in pairs))
        if shape == "flagship":
            record["spread_ms"]["k6"] = spread_ms("K6 flagship fp32", k6, 5)
        nfe_rows, accepted_rows = int(st[:, 0].sum()) * group, int(st[:, 1].sum()) * group
        bounds = kernel_bounds(n_in, h, nz, b, nfe_rows, accepted_rows)
        log(f"  bound {shape}: K5 {bounds['K5'][0]:.4f} ms ({bounds['K5'][1]}), K6 "
            f"{bounds['K6'][0]:.4f} ms ({bounds['K6'][1]}) for the steps these inputs took")
        results.append(dict(shape=shape, batch=b, widths=[n_in, h, h, nz], groups=st.shape[0],
                            nfe_rows=nfe_rows, accepted_rows=accepted_rows,
                            groups_with_other_steps=n_diff, k5_max_abs_err=err5,
                            k6_max_abs_err=err6, nfe_max=int(st[:, 0].max()), **ms))
        if shape in ("flagship", "h128"):
            surveys[shape] = step_survey(shape, dev, b, h, spread, SURVEY_SEEDS, 1 / 16)
    surveys["h128 random init"] = step_survey("h128 random init", dev, WIDE_BATCH, 128, False,
                                              SURVEY_SEEDS, None)
    record["adaptive_kernels_vs_plain"] = results
    record["adaptive_step_survey"] = surveys
    return results


class SolveSpy:
    """Records the solver stats of every ``odeint_diff`` call of the core."""

    def __init__(self):
        from continuousnormalizingflows_tpu_torch import core

        self.core, self.inner, self.stats = core, core.odeint_diff, []

    def __enter__(self):
        def spy(*a, **k):
            out = self.inner(*a, **k)
            self.stats.append(out[1])
            return out

        self.core.odeint_diff = spy
        return self

    def __exit__(self, *exc):
        self.core.odeint_diff = self.inner

    def last(self):
        s = self.stats[-1]
        return dict(nfe=int(s.nfe), naccept=int(s.naccept), nreject=int(s.nreject))


def adaptive_phase(dev, record):
    """The reference-default stack, fused=False: dopri5 at 1e-4 with the HNW
    start and the backsolve adjoint (and the quadrature adjoint, and the
    carried start) at the flagship batch."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    icnf = cnf.ICNF.create(nvariables=2)  # SolverConfig(): dopri5, 1e-4, adjoint, dt0="auto"
    if icnf.config.solver != SolverConfig():
        fail("the adaptive phase must run the default SolverConfig")
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    ts = torch.linspace(0.0, 1.0, 5, device=dev)
    calls = [
        ("TEST logpdf", lambda: cnf.ICNFDist(icnf, params, Mode.TEST).logpdf(x)),
        ("TRAIN logpdf", lambda: cnf.ICNFDist(icnf, params, Mode.TRAIN, gen(2)).logpdf(x)),
        ("TRAIN sample_with_logpdf",
         lambda: cnf.ICNFDist(icnf, params, Mode.TRAIN, gen(4)).sample_with_logpdf(n=BATCH)),
        ("TRAIN sample trace_free",
         lambda: cnf.ICNFDist(icnf, params, Mode.TRAIN, gen(5)).sample(BATCH, trace_free=True)),
        ("TEST trajectory (5 times)", lambda: cnf.trajectory(icnf, x, params, ts)),
    ]
    outs, stats, rates = {}, {}, {}
    with torch.no_grad():
        reset_counts()
        for name, fn in calls:
            with SolveSpy() as spy:
                outs[name] = fn()
            stats[name] = (spy.last() if spy.stats else
                           {k: int(getattr(outs[name][1], k)) for k in ("nfe", "naccept", "nreject")})
        if counts() != NO_LAUNCH:
            fail(f"the unfused adaptive calls launched kernels: {counts()}")
        for name, fn in calls:
            rates[name] = samples_per_s(f"{name} {stats[name]}", fn, BATCH)
        for name, out in outs.items():
            for p in (out if isinstance(out, tuple) else (out,)):
                if isinstance(p, torch.Tensor) and not torch.isfinite(p).all():
                    fail(f"{name}: non-finite output")
        lp_test, lp_train = outs["TEST logpdf"], outs["TRAIN logpdf"]
        s, lp = outs["TRAIN sample_with_logpdf"]
        path, _ = outs["TEST trajectory (5 times)"]
        if (lp_test.shape != (BATCH,) or lp_train.shape != (BATCH,) or s.shape != (BATCH, 2)
                or lp.shape != (BATCH,) or outs["TRAIN sample trace_free"].shape != (BATCH, 2)
                or path.shape != (5, BATCH, 5)):
            fail("adaptive phase: output shapes")
        if not torch.allclose(path[0, :, :2], x, rtol=1e-6, atol=1e-6):
            fail("trajectory at t0 is not the data")
        # the same 256 points on the card and on the CPU: the global error
        # norm depends on the batch, so both sides solve the same batch
        small = x[:256]
        params_cpu = {k: v.cpu() for k, v in params.items()}
        card = cnf.inference(icnf, Mode.TEST, small, params)
        cpu = cnf.inference(icnf, Mode.TEST, small.cpu(), params_cpu)
        if tuple(card[2][:3]) != tuple(cpu[2][:3]):
            fail(f"TEST logpdf card vs CPU: steps {tuple(card[2][:3])} vs {tuple(cpu[2][:3])}")
        err_cpu = compare("TEST logpdf card vs CPU (the same 256 points, the same steps "
                          f"{tuple(cpu[2][:3])})", card[0].cpu(), cpu[0], *SLICE_TOL)
    log(f"  TEST mean logpx {float(lp_test.mean()):.4f}")

    # fused=True with the default solver: no whole-solve kernel applies, so
    # every evaluation of the forward solve is a K1 launch and every VJP of
    # the backsolve adjoint a K2 launch (its stage again through K1)
    fused = cnf.ICNF.create(nvariables=2, fused=True)
    grads, solves = {}, {}
    for name, model in (("fused", fused), ("plain", icnf)):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        before = counts()
        l, st = cnf.loss_with_stats(model, Mode.TRAIN, x, p, gen(11))
        grads[name] = list(torch.autograd.grad(l, list(p.values())))
        moved = {k: counts()[k] - before[k] for k in before}
        solves[name] = tuple(int(v) for v in st[:3])
        log(f"  TRAIN loss and its gradients, fused={name == 'fused'}: launches {moved}, "
            f"forward solve {solves[name]}")
        if name == "fused" and (moved["K1"] == 0 or moved["K2"] == 0
                                or any(moved[k] for k in ("K3", "K4", "K5", "K6"))):
            fail(f"fused default stack: launches {moved}, expected K1 and K2 only")
        if name == "plain" and moved != NO_LAUNCH:
            fail(f"unfused default stack: launches {moved}")
    if solves["fused"] != solves["plain"]:
        fail(f"fused default stack: forward steps {solves['fused']} vs {solves['plain']}")
    err_k12 = compare_to_max("default stack, fused (K1 + K2) vs unfused: one step's parameter "
                             "gradients", grads["fused"], grads["plain"], GRAD_TOL)

    data = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), TRAIN_POINTS)
    fits = {}
    for gradient in ("adjoint", "quadrature"):
        for dt0 in ("auto", "carry"):
            model = cnf.ICNF.create(nvariables=2, solver=SolverConfig(gradient=gradient, dt0=dt0))
            name = f"fit gradient={gradient} dt0={dt0}"
            res, _l, rate = timed_fit(name, model, data, 2, NO_LAUNCH, dev)
            fits[name] = dict(train_samples_per_s=rate, history=res.history,
                              last_step={k: res.stats[k] for k in ("nfe", "naccept", "nreject")})
    record["adaptive"] = dict(samples_per_s=rates, solver_stats=stats, fits=fits,
                              card_vs_cpu_max_abs_err=err_cpu, fused_grad_max_abs_err=err_k12)


def adaptive_fused_phase(dev, record):
    """fused=True, fused_adaptive=True: TRAIN logpdf and loss through K5, fit
    through K5 + K6, one step's gradients against the unfused adjoint."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    fused = cnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True)
    params = fused.init(torch.Generator().manual_seed(0), device=dev)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    calls = [("TRAIN logpdf", lambda: cnf.inference(fused, Mode.TRAIN, x, params, gen(2))),
             ("TRAIN loss", lambda: cnf.loss_with_stats(fused, Mode.TRAIN, x, params, gen(6)))]
    data = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), TRAIN_POINTS)
    # the counted run of the main path
    reset_counts()
    outs = {}
    with torch.no_grad():
        for name, fn in calls:
            before = counts()
            outs[name] = fn()
            moved = {k: counts()[k] - before[k] for k in before}
            if moved != dict(NO_LAUNCH, K5=1):
                fail(f"fused adaptive {name}: launches {moved}, expected one K5")
    serving = counts()
    res, fit_launches, rate = timed_fit("fused adaptive fit", fused, data, 2,
                                        dict(NO_LAUNCH, K5=1, K6=1), dev)
    launches = {k: serving[k] + fit_launches[k] for k in serving}
    log(f"  launches on the fused adaptive path: {launches}")
    if launches["K5"] == 0 or launches["K6"] == 0:
        fail("a kernel of the fused adaptive path was not launched")
    lp, _augs, st = outs["TRAIN logpdf"]
    loss, _st = outs["TRAIN loss"]
    if lp.shape != (BATCH,) or not torch.isfinite(lp).all() or not torch.isfinite(loss):
        fail("fused adaptive: non-finite or misshapen output")
    solve = {k: int(getattr(st, k)) for k in ("nfe", "naccept", "nreject")}
    with torch.no_grad():
        rates = {"TRAIN logpdf (fused adaptive)": samples_per_s(
            f"TRAIN logpdf fused adaptive, worst group {solve}", calls[0][1], BATCH)}
    # one step's gradients at rtol = atol = 1e-6, same draws
    tight = SolverConfig(rtol=1e-6, atol=1e-6)
    models = {"fused": cnf.ICNF.create(nvariables=2, solver=tight, fused=True,
                                       fused_adaptive=True),
              "plain": cnf.ICNF.create(nvariables=2, solver=tight)}
    grads = {}
    for name, model in models.items():
        p = {k: v.detach().clone().requires_grad_() for k, v in res.params.items()}
        l = cnf.loss(model, Mode.TRAIN, x, p, gen(11))
        grads[name] = list(torch.autograd.grad(l, list(p.values())))
    err = compare_to_max("fused adaptive vs unfused backsolve: one step's parameter "
                         "gradients at rtol = atol = 1e-6", grads["fused"], grads["plain"],
                         ADAPTIVE_GRAD_TOL)
    record["adaptive_fused"] = dict(launches=launches, solve=solve, samples_per_s=rates,
                                    train_samples_per_s=rate, history=res.history,
                                    grad_max_abs_err=err)
    return launches


class KernelInputs:
    """Records what the core hands K5 (``fused_solve_dopri5``) in the last
    fused step run under it, and the cotangent of its u1 that K6 receives."""

    def __init__(self):
        from continuousnormalizingflows_tpu_torch import core

        self.core, self.inner, self.args, self.gbar = core, core.fused_solve_dopri5, None, None

    def __enter__(self):
        def spy(u0, eps, ys, params, tspan, nz, t_col, scfg, max_nodes):
            u1, rows = self.inner(u0, eps, ys, params, tspan, nz, t_col, scfg, max_nodes)
            self.args = (u0.detach(), eps.detach(), None if ys is None else ys.detach(),
                         {k: v.detach() for k, v in params.items()}, tspan, nz, t_col, scfg)
            self.max_nodes = max_nodes
            u1.register_hook(lambda g: setattr(self, "gbar", g.detach()))
            return u1, rows

        self.core.fused_solve_dopri5 = spy
        return self

    def __exit__(self, *exc):
        self.core.fused_solve_dopri5 = self.inner


def band_kernels(b, inputs, grads, names):
    """K5 and K6 on the band's own inputs (``KernelInputs`` of a fused step
    of band_phase) against their plain versions, as adaptive_kernel_phase
    holds them: K5's steps and u1 (at most one group in 16 with other steps,
    ADAPTIVE_TOL on the others); K6 per tensor to ADAPTIVE_BWD_TOL of its
    largest entry, with the step's own cotangent (zero on the groups of
    other steps, if any), and the step's parameter gradients (``grads``, by
    parameter name) to the same plain weight gradients where no group takes
    other steps; the replay's steps, two calls' bits.  Then each kernel's
    time beside the plain version's and the tiled path's, in turns, and the
    bound for the steps these inputs took.  The plain version runs in
    float32: at the band's random init the error ratios of the first trials
    are float32 rounding, so in float64 every group takes other steps (19
    NFE against 25; "h128 random init" in adaptive_kernel_phase)."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    args, max_nodes, gbar = inputs.args, inputs.max_nodes, inputs.gbar
    u0 = args[0]
    group = fa.fused_adaptive_tile(u0.shape[0])
    nz = args[5]
    n_in, h = args[3]["layers.0.weight"].shape[1], args[3]["layers.0.weight"].shape[0]
    k5 = lambda: fa.fused_solve_dopri5(*args, max_nodes)
    k5_ref = lambda: fa.fused_solve_dopri5_reference(*args, group)
    (u1, st), (u1_p, st_p) = k5(), k5_ref()
    same = (st[:, :3] == st_p[:, :3]).all(dim=1)
    n_diff = int((~same).sum())
    log(f"  K5 band's own inputs B={b}: {n_diff} of {st.shape[0]} groups take other steps than "
        f"the plain version; NFE {int(st[:, 0].min())}-{int(st[:, 0].max())}, accepted "
        f"{int(st[:, 1].min())}-{int(st[:, 1].max())}, rejected {int(st[:, 2].max())} at most")
    if n_diff * 16 > st.shape[0]:
        fail(f"K5 band's own inputs B={b}: {n_diff} of {st.shape[0]} groups differ in their "
             f"steps")
    again = k5()
    if not all(torch.equal(a.view(torch.int32), c.view(torch.int32))
               for a, c in zip((u1, st), again)):
        fail(f"K5 band's own inputs B={b}: two calls on the same inputs differ")
    keep = same.repeat_interleave(group)
    err5 = compare(f"K5 band's own inputs B={b} (groups of equal steps)", u1[keep], u1_p[keep],
                   *ADAPTIVE_TOL)
    gb = torch.where(keep[:, None], gbar, torch.zeros_like(gbar))
    k6 = lambda: fa.fused_solve_dopri5_bwd(*args, max_nodes, gb)
    k6_ref = lambda: fa.fused_solve_dopri5_bwd_reference(*args, max_nodes, gb, group)
    got, want = k6(), k6_ref()
    if not torch.equal(got[3], st[:, 1].to(torch.int32)):
        fail(f"K6 band's own inputs B={b}: the replay's accepted steps differ from K5's")
    err6 = compare_to_max(f"K6 band's own inputs B={b} vs the plain version",
                          [got[0], got[1], *got[2]], [want[0], want[1], *want[2]],
                          ADAPTIVE_BWD_TOL)
    again = k6()
    if not all(torch.equal(a, c) for a, c in zip((got[0], got[1], *got[2]),
                                                  (again[0], again[1], *again[2]))):
        fail(f"K6 band's own inputs B={b}: two calls on the same inputs differ")
    if n_diff == 0:  # the step's own gradients against the plain version's
        compare_to_max(f"[adaptive band] B={b}: the fused step's parameter gradients vs the "
                       f"plain version's", [grads[k] for k in names],
                       list(want[2]), ADAPTIVE_BWD_TOL)
    else:
        log(f"  [adaptive band] B={b}: {n_diff} groups take other steps in the plain version: "
            f"the step's gradients are held through K6 on the others")
    pairs = {"k5": (k5, k5_ref, 5, 1), "k6": (k6, k6_ref, 3, 1)}
    t = {k + sfx: [] for k in pairs for sfx in ("", "_plain", "_tiled")}
    for order in (("plain", "kernel", "tiled"), ("tiled", "kernel", "plain")):
        for which in order:
            for k, (kern, plain, reps_k, reps_p) in pairs.items():
                if which == "plain":
                    t[k + "_plain"].append(median_ms(plain, reps_p, warmup=1))
                    continue
                fa._WIDE_PATH = "tiled" if which == "tiled" else None
                try:
                    t[k + ("_tiled" if which == "tiled" else "")].append(
                        median_ms(kern, reps_k, warmup=1))
                finally:
                    fa._WIDE_PATH = None
    ms = {k: statistics.median(v) for k, v in t.items()}
    nfe_rows, accepted_rows = int(st[:, 0].sum()) * group, int(st[:, 1].sum()) * group
    bounds = kernel_bounds(n_in, h, nz, b, nfe_rows, accepted_rows)
    log(f"  time band's own inputs B={b} fp32: " + "; ".join(
        f"{k.upper()} {ms[k]:.4f} ms (tiled path {ms[k + '_tiled']:.4f} ms, plain "
        f"{ms[k + '_plain']:.4f} ms, bound {bounds[k.upper()][0]:.4f} ms)" for k in pairs)
        + f" ({nvidia_smi()})")
    return dict(batch=b, widths=[n_in, h, h, nz], groups=st.shape[0], nfe_rows=nfe_rows,
                accepted_rows=accepted_rows, nfe_max=int(st[:, 0].max()),
                groups_with_other_steps=n_diff,
                k5_max_abs_err=err5, k6_max_abs_err=err6, **ms)


def band_model(fused):
    """The JAX package's adaptive band (``benchmarks/adaptive_band.py``,
    "h=128 d=20"): ``ICNFConfig(nvariables=20)`` with its defaults (21
    augmented dimensions, so the net is 42 -> 128 -> 128 -> 41 and the state
    44 wide), dopri5 at rtol = atol = 1e-4 with the adjoint setting, the
    net in true fp32; ``fused`` takes K5 + K6."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import ICNFConfig, SolverConfig
    from continuousnormalizingflows_tpu_torch.models.nets import MLP

    cfg = ICNFConfig(nvariables=BAND_NVARIABLES,
                     solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                                         gradient="adjoint"),
                     fused=fused, fused_adaptive=fused)
    net = MLP((cfg.n_in, BAND_HIDDEN, BAND_HIDDEN, cfg.n_out), precision="highest")
    return cnf.ICNF(config=cfg, net=net)


def band_phase(dev, record):
    """[adaptive band]: the port's counterpart of the JAX package's
    ``benchmarks/adaptive_band.py`` ("h=128 d=20", batch 16,384 and 65,536):
    x = 0.5 randn(B, 20), BAND_STEPS TRAIN loss-and-gradient steps at fixed
    params (a fresh probe a step, so NFE is constant from step to step),
    fused (K5 + K6, exactly one launch of each a step) and unfused (dopri5
    with the backsolve adjoint, no kernel) in turns, each step's ms by the
    host clock; one more step of each under the profiler (device ms of K5
    and K6, idle share).  The two routes take other steps (the per-group
    controller from the fixed start against the global norm from the HNW
    start): their losses agree to O(tol), held to BAND_LOSS_RTOL."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    models = {"fused": band_model(True), "unfused": band_model(False)}
    cfg = models["fused"].config
    if not fa.fused_adaptive_applicable(cfg, models["fused"].net, Mode.TRAIN):
        fail("[adaptive band]: the fused config does not take K5 + K6")
    params = models["fused"].init(torch.Generator().manual_seed(0), device=dev)
    widths = (cfg.n_in, BAND_HIDDEN, BAND_HIDDEN, cfg.n_out)
    out = {}
    for b in BAND_BATCHES:
        plan = _build.cluster_plan(cfg.n_in, BAND_HIDDEN, cfg.n_out, cfg.nz, cfg.state_dim, 128, b)
        log(f"  band B={b}, net {widths}, state {cfg.state_dim}: {cluster_words(plan, b)}")
        x = 0.5 * torch.randn((b, BAND_NVARIABLES), generator=torch.Generator(device=dev)
                              .manual_seed(1), device=dev)
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}

        def step(route, seed):
            loss, st = cnf.loss_with_stats(models[route], Mode.TRAIN, x, p,
                                           torch.Generator(device=dev).manual_seed(seed))
            grads = torch.autograd.grad(loss, list(p.values()))
            return loss, st, grads

        runs = {route: [] for route in models}
        inputs, first = KernelInputs(), {}
        for i in range(BAND_STEPS):
            for route in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
                reset_counts()
                torch.cuda.synchronize()
                start = time.perf_counter()
                if i == 0 and route == "fused":  # K5's inputs and K6's cotangent, kept
                    with inputs:
                        loss, st, grads = step(route, 100 + i)
                else:
                    loss, st, grads = step(route, 100 + i)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - start) * 1e3
                moved = counts()
                want = dict(NO_LAUNCH, K5=1, K6=1) if route == "fused" else NO_LAUNCH
                if moved != want:
                    fail(f"[adaptive band] B={b} {route} step {i}: launches {moved}, expected "
                         f"{want}")
                if not torch.isfinite(loss) or not all(torch.isfinite(g).all() for g in grads):
                    fail(f"[adaptive band] B={b} {route} step {i}: non-finite loss or gradient")
                if i == 0:
                    first[route] = dict(zip(p, grads))
                runs[route].append(dict(ms=ms, loss=float(loss), launches=moved,
                                        nfe=int(st.nfe), naccept=int(st.naccept),
                                        nreject=int(st.nreject)))
        rel = max(abs(f["loss"] - u["loss"]) / abs(u["loss"])
                  for f, u in zip(runs["fused"], runs["unfused"]))
        if rel > BAND_LOSS_RTOL:
            fail(f"[adaptive band] B={b}: fused and unfused losses differ by {rel:.2e} "
                 f"relative, over {BAND_LOSS_RTOL}")
        # the routes take other steps: their gradients are logged, not bounded;
        # the fused step's are held to the plain versions in band_kernels
        grad_gap = max(float((first["fused"][k] - first["unfused"][k]).abs().max())
                       / float(first["unfused"][k].abs().max()) for k in p)
        log(f"  band B={b}: first step's gradients fused vs unfused: largest per-tensor "
            f"max-abs/max|unfused| {grad_gap:.3e}")
        if inputs.gbar is None:
            fail(f"[adaptive band] B={b}: the fused step's K5 inputs were not recorded")
        kernels = band_kernels(b, inputs, first["fused"], list(fa.params_of(range(6))))
        prof = {}
        for route in models:
            window = ProfileWindow()
            window.mark()
            step(route, 100)
            window.mark()
            prof[route] = window.summary(1, named={
                "K5": r"\badaptive_fwd_(cluster|tiled|rows)\b",
                "K6": r"\b(adaptive_bwd_cluster|adaptive_bwd|adaptive_replay\w*|walk_rows)\b"})
        summary = {}
        for route, steps in runs.items():
            ms = sorted(s["ms"] for s in steps)
            summary[route] = dict(ms_median=statistics.median(ms), ms_min=ms[0], ms_max=ms[-1],
                                  nfe=sorted({s["nfe"] for s in steps}),
                                  naccept=sorted({s["naccept"] for s in steps}),
                                  nreject=sorted({s["nreject"] for s in steps}),
                                  launches_per_step=steps[0]["launches"], profile=prof[route],
                                  steps=steps)
            pr = prof[route]
            log(f"  band B={b} {route}: {statistics.median(ms):.3f} ms a step (median of "
                f"{len(ms)}, min {ms[0]:.3f}, max {ms[-1]:.3f}); NFE {summary[route]['nfe']}, "
                f"accepted {summary[route]['naccept']}, rejected {summary[route]['nreject']}; "
                f"launches a step {steps[0]['launches']}; profiled step: device busy "
                f"{pr['busy_ms']:.3f} ms of {pr['step_ms']:.3f}, idle share "
                f"{pr['idle_share']:.3f}, K5 {pr['K5_ms']:.3f} ms, K6 {pr['K6_ms']:.3f} ms, "
                f"{pr['kernels']} kernels")
        log(f"  band B={b}: losses fused vs unfused within {rel:.2e} relative (bound "
            f"{BAND_LOSS_RTOL}) ok; fused step {summary['unfused']['ms_median'] / summary['fused']['ms_median']:.2f}x "
            f"the unfused one ({nvidia_smi()})")
        out[b] = dict(loss_rel=rel, grad_gap_unfused=grad_gap, plan=plan._asdict(),
                      kernels=kernels, **summary)
    record["adaptive_band"] = out
    return {k: sum(out[b]["fused"]["launches_per_step"][k] * BAND_STEPS for b in out)
            for k in NO_LAUNCH}, out[BAND_BATCHES[0]]["kernels"]


def cluster_words(plan, b) -> str:
    """K5's and K6's cluster plan (``_build.cluster_plan``) in words."""
    if not plan.cluster:
        return "K5 and K6 take the tiled path, one 256-thread block a 128-row group"
    weights = lambda res: "in shared memory" if res else "from L2"
    return (f"cluster path, {plan.cluster} CTAs a group ({plan.rows} rows each), grid "
            f"{b // (plan.rows * plan.cluster) * plan.cluster}; K5 and K6's replay "
            f"{plan.smem_fwd} B shared, weights {weights(plan.res_fwd)}, state "
            f"{'in shared memory' if plan.state_fwd else 'in the device scratch'}; K6's walk "
            f"{plan.smem_bwd} B shared, weights {weights(plan.res_bwd)}, passes of "
            f"{plan.walk_rows} rows, a {plan.share}-float share of the weight gradient a CTA")


def k1_k2_only(step):
    """K1 and K2 launched, no other kernel"""
    return step["K1"] > 0 and step["K2"] > 0 and not any(
        step[k] for k in ("K3", "K4", "K5", "K6"))


def solve_stats(st):
    return {k: int(getattr(st, k)) for k in ("nfe", "naccept", "nreject")}


def card_vs_cpu(name, icnf, mode, x, params, seed=None):
    """One ``inference`` of the same points (the first 256 of ``x``) on the card and on the CPU,
    with the same draws (a CPU generator on both sides): the same steps
    (the global error norm depends on the batch, so both solve one batch)
    and log-densities within SLICE_TOL."""
    import continuousnormalizingflows_tpu_torch as cnf

    small = x[:256]
    params_cpu = {k: v.detach().cpu() for k, v in params.items()}
    gen = (lambda: None) if seed is None else (lambda: torch.Generator().manual_seed(seed))
    with torch.no_grad():
        card = cnf.inference(icnf, mode, small, params, gen())
        cpu = cnf.inference(icnf, mode, small.cpu(), params_cpu, gen())
    if solve_stats(card[2]) != solve_stats(cpu[2]):
        fail(f"{name}: card vs CPU steps {solve_stats(card[2])} vs {solve_stats(cpu[2])}")
    return compare(f"{name}: card vs CPU (the same {len(small)} points, the same steps "
                   f"{tuple(solve_stats(cpu[2]).values())})", card[0].cpu(), cpu[0], *SLICE_TOL)


def loss_grads(icnf, x, params, generator, mode=None):
    """One loss and its parameter gradients: (loss, grads, solver stats)."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode

    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    l, st = cnf.loss_with_stats(icnf, mode or Mode.TRAIN, x, p, generator)
    return l.detach(), list(torch.autograd.grad(l, list(p.values()))), st


def abm_phase(dev, record):
    """The reference's default stack: abm (adaptive order) with the
    quadrature adjoint at bench.py's abm + quadrature row, on the flagship
    at 65,536 samples; unfused, and fused through K1 + K2."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    solver = SolverConfig(**ABM_SOLVER)
    icnf = cnf.ICNF.create(nvariables=2, solver=solver)
    if icnf.net.widths != (6, 24, 24, 5) or icnf.net.precision != "highest":
        fail("the abm phase must run the flagship net in full float32")
    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    ts = torch.linspace(0.0, 1.0, 5, device=dev)
    calls = [
        ("TEST logpdf", lambda: cnf.ICNFDist(icnf, params, Mode.TEST).logpdf(x)),
        ("TRAIN logpdf", lambda: cnf.ICNFDist(icnf, params, Mode.TRAIN, gen(2)).logpdf(x)),
        ("TRAIN sample_with_logpdf",
         lambda: cnf.ICNFDist(icnf, params, Mode.TRAIN, gen(4)).sample_with_logpdf(n=BATCH)),
        ("TEST trajectory (5 times)", lambda: cnf.trajectory(icnf, x, params, ts)),
    ]
    outs, stats, rates = {}, {}, {}
    with torch.no_grad():
        reset_counts()
        for name, fn in calls:
            with SolveSpy() as spy:
                outs[name] = fn()
            stats[name] = spy.last() if spy.stats else solve_stats(outs[name][1])
        if counts() != NO_LAUNCH:
            fail(f"the unfused abm calls launched kernels: {counts()}")
        for name, fn in calls:
            rates[name] = samples_per_s(f"{name} {stats[name]}", fn, BATCH)
        for name, out in outs.items():
            for p in (out if isinstance(out, tuple) else (out,)):
                if isinstance(p, torch.Tensor) and not torch.isfinite(p).all():
                    fail(f"abm {name}: non-finite output")
        s, lp = outs["TRAIN sample_with_logpdf"]
        path, _ = outs["TEST trajectory (5 times)"]
        if (outs["TEST logpdf"].shape != (BATCH,) or outs["TRAIN logpdf"].shape != (BATCH,)
                or s.shape != (BATCH, 2) or lp.shape != (BATCH,) or path.shape != (5, BATCH, 5)):
            fail("abm phase: output shapes")
        if not torch.allclose(path[0, :, :2], x, rtol=1e-6, atol=1e-6):
            fail("abm trajectory at t0 is not the data")
    err_cpu = card_vs_cpu("abm TEST logpdf", icnf, Mode.TEST, x, params)
    log(f"  TEST mean logpx {float(outs['TEST logpdf'].mean()):.4f}")

    # fused=True: every forward evaluation is a K1 launch, every VJP of the
    # quadrature adjoint a K2 launch (its stage again through K1); the
    # counted run of this path: counts at 0 just before, read just after
    fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True)
    grads, solves = {}, {}
    for name, model in (("plain", icnf), ("fused", fused)):
        reset_counts()
        _l, grads[name], st = loss_grads(model, x, params, gen(11))
        moved = counts()
        solves[name] = solve_stats(st)
        log(f"  TRAIN loss and its gradients, fused={name == 'fused'}: launches {moved}, "
            f"forward solve {solves[name]}")
        if name == "fused" and not k1_k2_only(moved):
            fail(f"fused abm + quadrature: launches {moved}, expected K1 and K2 only")
        if name == "plain" and moved != NO_LAUNCH:
            fail(f"unfused abm + quadrature: launches {moved}")
        if name == "fused":
            launches = moved
    if solves["fused"] != solves["plain"]:
        fail(f"fused abm: forward steps {solves['fused']} vs {solves['plain']}")
    err_k12 = compare_to_max("abm + quadrature, fused (K1 + K2) vs unfused: one step's "
                             "parameter gradients", grads["fused"], grads["plain"], GRAD_TOL)

    data = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), TRAIN_POINTS)
    fits = {}
    for name, model, want in (("fit abm + quadrature", icnf, NO_LAUNCH),
                              ("fit abm + quadrature, fused=True", fused, k1_k2_only)):
        res, fit_launches, rate = timed_fit(name, model, data, 2, want, dev)
        fits[name] = dict(train_samples_per_s=rate, history=res.history, launches=fit_launches,
                          last_step={k: res.stats[k] for k in ("nfe", "naccept", "nreject")})

    # the order cap at a tight tolerance against dopri5: NFE of TEST logpdf
    orders = {}
    with torch.no_grad():
        for name, tight in (("dopri5", SolverConfig(rtol=1e-6, atol=1e-6)),
                            *((f"abm{k}", SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                                                       abm_order=k, gradient="quadrature"))
                              for k in (4, 8, 12))):
            model = cnf.ICNF.create(nvariables=2, solver=tight)
            (lp_k, _a, st), sec = host_seconds(lambda: cnf.inference(model, Mode.TEST, x, params))
            if not torch.isfinite(lp_k).all():
                fail(f"TEST logpdf at 1e-6, {name}: non-finite")
            orders[name] = dict(solve_stats(st), seconds=sec)
            log(f"  TEST logpdf at rtol = atol = 1e-6, {name}: {orders[name]}")
    record["abm"] = dict(solver_stats=stats, samples_per_s=rates, card_vs_cpu_max_abs_err=err_cpu,
                         fused_launches=launches, fused_forward=solves["fused"],
                         fused_grad_max_abs_err=err_k12, fits=fits, orders_at_1e6=orders)
    return launches


def nets_phase(dev, record):
    """The rest of the model surface on the card at 65,536 samples: the
    planar net (analytic trace), the exact sweep (unchunked and in blocks),
    its Frobenius regularizer, the Hutchinson JVP, a CondLayer, a
    from_torch net and a logistic base with a uniform probe; each against
    the CPU on 256 points."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch import distributions as dists
    from continuousnormalizingflows_tpu_torch.config import ICNFConfig, Mode, TraceEstimator
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    cfg = ICNFConfig(nvariables=2)
    mlp3 = cnf.MLP((cfg.n_in, 24, 24, 24, cfg.n_out))
    module = torch.nn.Sequential(torch.nn.Linear(cfg.n_in, 24), torch.nn.Tanh(),
                                 torch.nn.Linear(24, 24), torch.nn.Tanh(),
                                 torch.nn.Linear(24, cfg.n_out))
    cases = [  # (name, model, modes: TEST logpdf and/or TRAIN loss with gradients)
        ("Planar (analytic planar trace)",
         cnf.ICNF(config=cfg, net=cnf.Planar(cfg.n_in, cfg.n_out)), ("test", "train")),
        ("MLP 3 hidden layers, exact sweep",
         cnf.ICNF(config=cfg, net=mlp3), ("test",)),
        ("MLP 3 hidden layers, exact sweep, exact_chunk=2",
         cnf.ICNF(config=ICNFConfig(nvariables=2, exact_chunk=2), net=mlp3), ("test",)),
        ("MLP 3 hidden layers, trace=EXACT, lambda_2 = 0.01 (Frobenius sweep)",
         cnf.ICNF(config=ICNFConfig(nvariables=2, trace=TraceEstimator.EXACT), net=mlp3),
         ("train",)),
        ("HUTCH_JVP", cnf.ICNF.create(nvariables=2, trace=TraceEstimator.HUTCH_JVP), ("train",)),
        ("CondLayer(MLP)", cnf.ICNF(config=cfg, net=cnf.CondLayer(
            cnf.MLP((cfg.n_in + 2, 24, 24, cfg.n_out)), torch.tensor([0.5, -1.0]))),
         ("test", "train")),
        ("from_torch(Linear-Tanh x2-Linear)",
         cnf.ICNF(config=cfg, net=cnf.from_torch(module, cfg.n_in, cfg.n_out)),
         ("test", "train")),
        ("logistic() base, uniform_probe()",
         cnf.ICNF.create(nvariables=2, base_dist=dists.logistic(),
                         probe_dist=dists.uniform_probe()), ("test", "train")),
    ]
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    out, test_lp = {}, {}
    reset_counts()
    for name, icnf, modes in cases:
        params = icnf.init(torch.Generator().manual_seed(0), device=dev)
        row = {}
        if "test" in modes:
            with torch.no_grad():
                (lp, _a, st), sec = host_seconds(lambda: cnf.inference(icnf, Mode.TEST, x, params))
            if lp.shape != (BATCH,) or not torch.isfinite(lp).all():
                fail(f"{name}: TEST logpdf non-finite or misshapen")
            row["test"] = dict(solve_stats(st), samples_per_s=BATCH / sec)
            test_lp[name] = lp
            row["test_card_vs_cpu"] = card_vs_cpu(f"{name} TEST", icnf, Mode.TEST, x, params)
        if "train" in modes:
            (l, grads, st), sec = host_seconds(
                lambda: loss_grads(icnf, x, params, torch.Generator(device=dev).manual_seed(3)))
            if not torch.isfinite(l) or not all(torch.isfinite(g).all() for g in grads):
                fail(f"{name}: TRAIN loss or gradients non-finite")
            row["train"] = dict(solve_stats(st), loss=float(l), train_samples_per_s=BATCH / sec)
            row["train_card_vs_cpu"] = card_vs_cpu(f"{name} TRAIN", icnf, Mode.TRAIN, x, params,
                                                   seed=5)
        log(f"  {name} (one call each): " + "; ".join(
            f"{m} {row[m]}" for m in ("test", "train") if m in row))
        out[name] = row
    if counts() != NO_LAUNCH:
        fail(f"the nets phase launched kernels: {counts()}")
    compare("exact sweep unchunked vs exact_chunk=2 (65,536 points)",
            test_lp["MLP 3 hidden layers, exact sweep, exact_chunk=2"],
            test_lp["MLP 3 hidden layers, exact sweep"], *SLICE_TOL)
    record["nets"] = out


def image_model(side, h, fused=False, eval_twin=False, solver=None, hidden=2, activation=None,
                base_dist=None):
    """``benchmarks/image_bitsdim.py``'s model at ``side`` (d = side^2) and
    width ``h``: no augmentation, lambda_1 = lambda_2 = 0.01, lambda_3 = 0,
    no steering, rk4-24 with backprop and bf16 products; its eval twin
    dopri5 at rtol = atol = 1e-4 with float32 products.  ``solver`` (a
    ``SolverConfig``) replaces either's; ``hidden`` hidden layers of ``h``,
    ``activation`` in place of softplus, ``base_dist`` in place of the
    normal base."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import SolverConfig

    if solver is None:
        solver = (SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4) if eval_twin else
                  SolverConfig(method="rk4", gradient="backprop", fixed_steps=IMAGE_RK4_STEPS))
    cfg = cnf.ICNFConfig(nvariables=side * side, naugments=0, lambda_1=0.01, lambda_2=0.01,
                         lambda_3=0.0, steer_rate=0.0, solver=solver, fused=fused,
                         base_dist=base_dist)
    net_kw = {} if activation is None else {"activation": activation}
    return cnf.ICNF(config=cfg, net=cnf.MLP((cfg.n_in,) + (h,) * hidden + (cfg.n_out,),
                                            precision="highest" if eval_twin else "default",
                                            **net_kw))


def image_fit(name, icnf, data, steps, want, dev, batch_transform=None, trace_dir=None,
              save_dir=None, mesh=None, profile=None, batch=None):
    """``steps`` steps of ``ICNFModel.fit`` at ``batch`` (IMAGE_BATCH), every step's
    launches held to ``want``, timed by the port's ``StepTimer`` from the end
    of the first step to the end of the last but one.  With ``trace_dir``
    the last step runs under ``profiling.trace``, and its trace must name
    K1's and K2's kernels; with ``save_dir`` an ``AsyncCheckpointer`` saves the live
    parameters and optimizer state after the middle step while the next step
    updates them in place, and the reloaded file must equal the parameters
    as they stood at ``save()`` bit for bit.  ``mesh``: the fit runs with
    ``ICNFModel(mesh=)``.  ``profile``: a dict that gets the device profile
    of the two steps after the first (:class:`ProfileWindow`).  ``want`` may
    be a function ``want(step index, that step's launches) -> bool`` whose
    docstring says what it expects.  Returns (result, samples/s, launches)."""
    import contextlib
    import glob

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.utils import (AsyncCheckpointer, load_checkpoint,
                                                            profiling)

    batch = batch or IMAGE_BATCH
    opt_box = {}

    def optimizer(tensors):
        opt_box["opt"] = cnf.default_optimizer()(tensors)
        return opt_box["opt"]

    params = icnf.init(torch.Generator().manual_seed(0), device=dev)
    live = lambda: dict(zip(params, opt_box["opt"].param_groups[0]["params"]))
    timer = profiling.StepTimer(batch)
    timed_until = steps - 1  # the last step is traced where asked: both routes time the same
    marks, at_save, rate = [counts()], {}, []
    tracing = contextlib.ExitStack()
    ck = AsyncCheckpointer()
    window = ProfileWindow() if profile is not None else None

    def on_step(it, _loss):  # step `it` has ended: reading its loss synchronised the stream
        marks.append(counts())
        if window is not None and it in (0, 2):
            window.mark()
        if it < timed_until:
            timer.tick(list(live().values()))
        if it == timed_until - 1:
            rate.append(timer.samples_per_sec)
            log(f"  {name}: {timer.steps} steps timed by StepTimer, "
                f"{timer.seconds_per_step * 1e3:.3f} ms a step, {rate[0]:.1f} train samples/s "
                f"({nvidia_smi()})")
            if trace_dir:
                tracing.enter_context(profiling.trace(trace_dir))
        if it == steps - 1:
            tracing.close()
        if save_dir and it == steps // 2:
            at_save.update({k: v.detach().clone() for k, v in live().items()})
            ck.save(save_dir, live(), opt_box["opt"].state_dict(), step=it + 1)

    model = cnf.ICNFModel(icnf, optimizer=optimizer, batchsize=batch, epochs=1,
                          log_every=1, callback=on_step, batch_transform=batch_transform,
                          device=dev, generator=torch.Generator(device=dev).manual_seed(7),
                          mesh=mesh)
    reset_counts()
    marks[0] = counts()
    res = model.fit(data[: steps * batch], params=params)
    ck.wait()
    if window is not None:
        profile.update(window.summary(2))
    if res.stats["iterations"] != steps or not all(map(math.isfinite, res.history)):
        fail(f"{name}: {res.stats['iterations']} steps, loss history {res.history}")
    expected = " ".join(want.__doc__.split()) if callable(want) else want
    for i in range(1, len(marks)):
        step = {k: marks[i][k] - marks[i - 1][k] for k in NO_LAUNCH}
        if not (want(i - 1, step) if callable(want) else step == want):
            fail(f"{name}: step {i - 1} launched {step}, expected {expected}")
    log(f"  {name}: {steps} steps, each launching {expected} ok; loss {res.history[0]:.2f} -> "
        f"{res.history[-1]:.2f}")
    if trace_dir:
        names = set()
        for path in glob.glob(f"{trace_dir}/*.pt.trace.json"):
            names |= {e.get("name", "") for e in json.loads(Path(path).read_text())["traceEvents"]
                      if e.get("cat") == "kernel"}
        # K1 and K2 at these widths run their wide paths, whose products are
        # wide_products with K1's and K2's own epilogue types
        found = {k: sorted(n for n in names if re.search(pat, n)) for k, pat in (
            ("fwd", r"wide_products<.*\bFwdEpi"), ("bwd", r"wide_products<.*\bBwdEpi"))}
        if not all(found.values()):
            fail(f"{name}: the traced step's kernels do not name K1's and K2's wide paths: "
                 f"{sorted(names)[:20]}")
        log(f"  {name}: profiling.trace of the last step names K1's wide path "
            f"{found['fwd'][0][:90]} and K2's {found['bwd'][0][:90]} ok")
    if save_dir:
        got, opt_state, step = load_checkpoint(save_dir)
        if step != steps // 2 + 1 or opt_state is None or set(got) != set(at_save) or not all(
                torch.equal(got[k], at_save[k].cpu()) for k in at_save):
            fail(f"{name}: the reloaded checkpoint differs from the parameters at save()")
        if all(torch.equal(at_save[k], res.params[k]) for k in at_save):
            fail(f"{name}: the parameters did not move after save()")
        log(f"  {name}: AsyncCheckpointer.save after step {steps // 2} (the next step updating "
            f"in place meanwhile), reloaded: equal bit for bit to the parameters at save() ok")
    return res, rate[0], {k: marks[-1][k] - marks[0][k] for k in NO_LAUNCH}


def image_phase(dev, record):
    """The image-scale FFJORD path at full width and the digits-shaped path,
    through the utils layer: (a) the image model (d = 784, 785 -> 1024 ->
    1024 -> 784, bf16, rk4-24, batch 256) fitted through K1 + K2, timed,
    traced and checkpointed during the fit, and the same fit unfused; (b) its
    dopri5 eval twin exported, saved, loaded and served on 256 points against
    the eager call and the CPU, with bits/dim beside the true density's; (c)
    the digits-shaped model (d = 64, h = 256) fitted through K3 + K4 with
    ``random_shift_images`` as the batch transform, then its sampler
    exported."""
    import functools
    import shutil

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode
    from continuousnormalizingflows_tpu_torch.utils import datasets as ds
    from continuousnormalizingflows_tpu_torch.utils import export as ex

    started = time.perf_counter()
    work = Path("chiprun_out") / "image_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # (a) the image fit, fused and unfused
    side, h = IMAGE_SIDE, IMAGE_HIDDEN
    d = side * side
    x = ds.smooth_image_mixture(gen(1), IMAGE_POINTS, side)
    res, rate, launched = image_fit(
        "image fused=True (K1 + K2)", image_model(side, h, fused=True), x, IMAGE_FIT_STEPS,
        dict(NO_LAUNCH, K1=8 * IMAGE_RK4_STEPS, K2=4 * IMAGE_RK4_STEPS), dev,
        trace_dir=str(work / "trace"), save_dir=str(work / "ckpt"))
    _r, rate_plain, _n = image_fit("image fused=False", image_model(side, h), x, IMAGE_FIT_STEPS,
                                   NO_LAUNCH, dev)
    log(f"  image train samples/s: fused {rate:.1f}, unfused {rate_plain:.1f} "
        f"(fused / unfused {rate / rate_plain:.3f}) on {nvidia_smi()}")
    out["fit"] = dict(train_samples_per_s=rate, train_samples_per_s_unfused=rate_plain,
                      history=res.history, launches=launched)

    # (b) serving the image flow: export, save, load, call on 256 points
    ev = image_model(side, h, eval_twin=True)
    x_eval = ds.smooth_image_mixture(gen(2), 256, side)
    params = res.params
    (art, export_s) = host_seconds(lambda: ex._export_logpdf(ev, params, device=dev))
    ex.save_artifact(str(work / "image_logpdf.pt2"), art)
    served = ex.load_artifact(str(work / "image_logpdf.pt2"))
    (lp, nfe, nacc, nrej), call_s = host_seconds(lambda: served.call(x_eval))
    with torch.no_grad():
        (lp_eager, _a, st), eager_s = host_seconds(
            lambda: cnf.inference(ev, Mode.TEST, x_eval, params))
    got_stats = {"nfe": int(nfe), "naccept": int(nacc), "nreject": int(nrej)}
    if got_stats != solve_stats(st):
        fail(f"exported image logpdf: solver stats {got_stats} vs eager {solve_stats(st)}")
    err = compare(f"exported image logpdf vs eager log_prob(TEST), 256 points, steps "
                  f"{tuple(got_stats.values())}", lp, lp_eager, EXPORT_RTOL, 0.0)
    cpu_err = card_vs_cpu("image eval (dopri5 1e-4)", ev, Mode.TEST, x_eval[:64], params)
    bpd = float(ds.nats_to_bits_per_dim(-lp.mean(), d))
    true_bpd = float(ds.nats_to_bits_per_dim(-ds.smooth_image_mixture_logpdf(x_eval, side).mean(),
                                             d))
    rates = {"exported": samples_per_s("exported image logpdf, 256 points",
                                       lambda: served.call(x_eval), 256),
             "eager": samples_per_s("eager image log_prob(TEST), 256 points",
                                    lambda: cnf.log_prob(ev, Mode.TEST, x_eval, params), 256)}
    log(f"  image eval: export {export_s:.1f} s, first served call {call_s:.3f} s, eager "
        f"{eager_s:.3f} s; NFE {got_stats['nfe']}; {bpd:.4f} bits/dim after "
        f"{IMAGE_FIT_STEPS} steps (the true density: {true_bpd:.4f} bits/dim)")
    out["serve"] = dict(stats=got_stats, max_abs_err=err, card_vs_cpu_max_abs_err=cpu_err,
                        bits_per_dim=bpd, true_bits_per_dim=true_bpd, export_s=export_s,
                        samples_per_s=rates)

    # (c) the digits-shaped fit through K3 + K4, then its exported sampler
    dside, dh = DIGITS_SIDE, DIGITS_HIDDEN
    xd = ds.smooth_image_mixture(gen(3), IMAGE_POINTS, dside)
    shift = functools.partial(ds.random_shift_images, side=dside, prob=0.5)
    res_d, rate_d, launched_d = image_fit("digits-shaped fused=True (K3 + K4)",
                                          image_model(dside, dh, fused=True), xd,
                                          IMAGE_FIT_STEPS, dict(NO_LAUNCH, K3=1, K4=1), dev,
                                          batch_transform=shift)
    dev_eval = image_model(dside, dh, eval_twin=True)
    sampler = ex.export_sampler(dev_eval, res_d.params, 64, device=dev)
    s1, s2 = sampler.call(11), sampler.call(11)
    ex.save_artifact(str(work / "digits_sampler.pt2"), sampler)
    s3 = ex.load_artifact(str(work / "digits_sampler.pt2")).call(11)
    if s1.shape != (64, dside * dside) or not (torch.equal(s1, s2) and torch.equal(s1, s3)):
        fail("exported sampler: shape, or the same seed gave other bits (twice, after a reload)")
    with torch.no_grad():
        want = cnf.generate(dev_eval, Mode.TEST, res_d.params, gen(11), 64, trace_free=True)
    s_err = compare("exported digits-shaped sampler vs eager generate (seed 11, 64 samples)",
                    s1, want, EXPORT_RTOL, 1e-6)
    log("  exported sampler: seed 11 twice and after a reload, the same bits ok")
    out["digits"] = dict(train_samples_per_s=rate_d, history=res_d.history,
                         sampler_max_abs_err=s_err, launches=launched_d)
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - started
    log(f"  [image] phase: {out['seconds']:.1f} s")
    record["image"] = out

def export_eval_model(solver=None, side=None, h=None, **kw):
    """[export]'s served model: the digits-shaped eval twin (65 -> 256 ->
    256 -> 64, float32 products), on the reference's default solver (abm)
    unless ``solver`` says otherwise."""
    from continuousnormalizingflows_tpu_torch.config import SolverConfig

    return image_model(side or DIGITS_SIDE, h or DIGITS_HIDDEN, eval_twin=True,
                       solver=solver or SolverConfig(method="abm", gradient="quadrature"), **kw)


def served_vs_eager(name, icnf, params, x, work):
    """Export ``icnf``'s TEST log-density with ``params``, save, load and
    serve ``x``; the served call's steps and bits must be the eager
    ``inference``'s, and neither may launch a kernel.  Returns (served logp,
    stats, export seconds, the loaded artifact)."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode
    from continuousnormalizingflows_tpu_torch.utils import export as ex

    reset_counts()
    art, export_s = host_seconds(lambda: ex._export_logpdf(icnf, params, device=x.device))
    path = str(work / f"{re.sub(r'[^a-z0-9]+', '_', name.lower())}.pt2")
    ex.save_artifact(path, art)
    served = ex.load_artifact(path)
    lp, nfe, nacc, nrej = served.call(x)
    with torch.no_grad():
        eager, _a, st = cnf.inference(icnf, Mode.TEST, x, params)
    stats = {"nfe": int(nfe), "naccept": int(nacc), "nreject": int(nrej)}
    if stats != solve_stats(st):
        fail(f"{name}: the served call's steps {stats} vs the eager call's {solve_stats(st)}")
    if not torch.equal(lp, eager) or not torch.isfinite(lp).all() or lp.shape != (x.shape[0],):
        fail(f"{name}: the served log-density is not the eager call's bits (max abs diff "
             f"{float((lp - eager).abs().max()):.3e})")
    if counts() != NO_LAUNCH:
        fail(f"{name}: the TEST calls launched kernels {counts()}")
    log(f"  {name}: exported in {export_s:.1f} s, saved, loaded, served {x.shape[0]} points: "
        f"steps {tuple(stats.values())} and bits equal to the eager call's ok")
    return lp, stats, export_s, served


def export_rank(rank, world, store, work):
    """A rank of [export]'s gloo mesh on the one card: exports the served
    model on a ``world x 1`` mesh and serves its 1 / ``world`` of the points;
    its log-densities and steps to ``work/r<rank>.pt``, a failure's
    traceback to ``work/error_r<rank>.txt``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        inputs = torch.load(Path(work) / "inputs.pt")
        dev = torch.device(inputs["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        from continuousnormalizingflows_tpu_torch.parallel import (initialize_distributed,
                                                                   make_mesh, shard_batch_arrays)
        from continuousnormalizingflows_tpu_torch.utils import export as ex

        initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                               rank=rank, timeout=datetime.timedelta(seconds=PARALLEL_JOIN_S))
        mesh = make_mesh(device=dev)
        params = {k: v.to(dev) for k, v in inputs["params"].items()}
        rows, _ = shard_batch_arrays(mesh, inputs["x"].to(dev))
        model = export_eval_model(side=inputs["side"], h=inputs["h"])
        t0 = time.perf_counter()
        art = ex._export_logpdf(model, params, mesh=mesh)
        export_s = time.perf_counter() - t0
        lp, nfe, nacc, nrej = art.call(rows)
        torch.save(dict(lp=lp.cpu(), rows=rows.shape[0], export_s=export_s, mesh=art.mesh,
                        stats={"nfe": int(nfe), "naccept": int(nacc), "nreject": int(nrej)}),
                   Path(work) / f"r{rank}.pt")
        dist.destroy_process_group()
    except Exception:
        Path(work, f"error_r{rank}.txt").write_text(traceback.format_exc())
        raise


def export_phase(dev, record):
    """The rest of the serving export at the digits widths: (a) the
    digits-shaped model (65 -> 256 -> 256 -> 64) fitted 4 steps at B = 256 on
    the reference's default stack (abm with the quadrature adjoint) with
    ``fused=True``, through K1 + K2 on their wide paths, each step's
    launches counted against its forward solve; then its float32 eval twin
    (abm) exported, saved, loaded and served 256 points with the eager
    call's steps and bits, both timed; (b) the exact trace of nets the
    analytic trace does not cover, served likewise (dopri5): a 3-hidden-layer
    net (the written-out sweep) and a gelu twin of the digits net; (c) a
    Student-t base's exported sampler, the eager ``generate``'s bits for the
    same seed, twice and after a reload; (d) ``export_logpdf(mesh=)`` on an
    NCCL world of 1 (the unsharded served bits) and on 2 gloo ranks on the
    card, each serving 128 of the points with the unsharded steps (they run
    beside (b), (c) and the world of 1, after (a)'s timings)."""
    import shutil

    import torch.distributed as dist
    import torch.nn.functional as F

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch import distributions as dists
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.parallel import initialize_distributed, make_mesh
    from continuousnormalizingflows_tpu_torch.utils import datasets as ds
    from continuousnormalizingflows_tpu_torch.utils import export as ex

    started = time.perf_counter()
    work = Path("chiprun_out") / "export_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    side, h = DIGITS_SIDE, DIGITS_HIDDEN
    out = {}

    # (a) the fit on the default stack through K1 + K2, then the eval twin served
    default_stack = SolverConfig(method="abm", gradient="quadrature")
    x = ds.smooth_image_mixture(gen(5), EXPORT_FIT_STEPS * IMAGE_BATCH, side)
    steps = []
    with SolveSpy() as spy:
        def want(i, step):
            """K1 = the step's forward NFE + K2 (each VJP of the quadrature adjoint runs its
            stage through K1, its backward through K2), K2 > 0, no other kernel"""
            steps.append({k: step[k] for k in ("K1", "K2")})
            return (step["K2"] > 0 and step["K1"] == int(spy.stats[i].nfe) + step["K2"]
                    and not any(step[k] for k in ("K3", "K4", "K5", "K6")))

        res, rate, launched = image_fit(
            "digits-shaped, abm + quadrature, fused=True (K1 + K2)",
            image_model(side, h, fused=True, solver=default_stack), x, EXPORT_FIT_STEPS, want,
            dev)
        forward = [solve_stats(st) for st in spy.stats]
    if len(forward) != EXPORT_FIT_STEPS:
        fail(f"export fit: {len(forward)} forward solves in {EXPORT_FIT_STEPS} steps")
    plan_fwd = _plan_path("fwd", side * side + 1, h, side * side)
    plan_bwd = _plan_path("bwd", side * side + 1, h, side * side)
    if plan_fwd != "wide" or plan_bwd != "wide":
        fail(f"export fit: K1 takes its {plan_fwd} path, K2 its {plan_bwd} path at the digits "
             f"widths, not the wide ones")
    log(f"  the fit's forward solves {forward}; launches a step {steps} (K1 and K2 on their "
        f"wide paths); {rate:.1f} train samples/s ({nvidia_smi()})")
    out["fit"] = dict(history=res.history, launches=launched, launches_a_step=steps,
                      forward=forward, train_samples_per_s=rate)
    params = res.params
    ev = export_eval_model()
    x_eval = ds.smooth_image_mixture(gen(6), EXPORT_POINTS, side)
    lp, stats, export_s, served = served_vs_eager("digits abm eval", ev, params, x_eval, work)
    rates = {"served": samples_per_s(f"served digits abm logpdf, {EXPORT_POINTS} points",
                                     lambda: served.call(x_eval), EXPORT_POINTS),
             "eager": samples_per_s(f"eager digits abm log_prob(TEST), {EXPORT_POINTS} points",
                                    lambda: cnf.log_prob(ev, Mode.TEST, x_eval, params),
                                    EXPORT_POINTS)}
    log(f"  digits abm eval: export {export_s:.1f} s; served {rates['served']:.1f} vs eager "
        f"{rates['eager']:.1f} samples/s ({nvidia_smi()})")
    out["abm"] = dict(stats=stats, export_s=export_s, samples_per_s=rates)
    # (d)'s gloo ranks export and serve while (b), (c) and the world of 1 run here
    torch.save(dict(params={k: v.cpu() for k, v in params.items()}, x=x_eval.cpu(),
                    device=str(dev), side=side, h=h), work / "inputs.pt")
    ranks = start_ranks(export_rank, EXPORT_RANKS, work)

    # (b) the exact trace of nets the analytic trace does not cover
    out["nets"] = {}
    for name, model in (
            ("3 hidden layers, the written-out sweep", export_eval_model(
                SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4), hidden=3)),
            ("gelu, the analytic trace with the written-out gelu'", export_eval_model(
                SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4), activation=F.gelu))):
        p = model.init(torch.Generator().manual_seed(0), device=dev)
        _lp, st, sec, _art = served_vs_eager(f"dopri5 {name}", model, p, x_eval, work)
        out["nets"][name] = dict(stats=st, export_s=sec)

    # (c) a Student-t base's exported sampler
    st_model = export_eval_model(base_dist=dists.student_t(4.0))
    sampler, sampler_s = host_seconds(lambda: ex.export_sampler(st_model, params, EXPORT_POINTS,
                                                                device=dev))
    s1, s2 = sampler.call(13), sampler.call(13)
    ex.save_artifact(str(work / "student_sampler.pt2"), sampler)
    s3 = ex.load_artifact(str(work / "student_sampler.pt2")).call(13)
    with torch.no_grad():
        want_s = cnf.generate(st_model, Mode.TEST, params, gen(13), EXPORT_POINTS,
                              trace_free=True)
    if (s1.shape != (EXPORT_POINTS, side * side) or not torch.isfinite(s1).all()
            or not all(torch.equal(s1, v) for v in (s2, s3, want_s))):
        fail("Student-t sampler: the shape, or the same seed gave other bits (twice, after a "
             "reload, or against the eager generate)")
    log(f"  Student-t(4) base: the sampler exported in {sampler_s:.1f} s; seed 13 twice, after "
        f"a reload and eagerly: the same bits ok")
    out["student_t"] = dict(export_s=sampler_s)

    # (d) export_logpdf(mesh=): an NCCL world of 1, then 2 gloo ranks on the card
    initialize_distributed(backend="nccl", store=dist.HashStore(), world_size=1, rank=0)
    mesh = make_mesh()
    one = ex._export_logpdf(ev, params, mesh=mesh)
    lp1, *st1 = one.call(x_eval)
    st1 = dict(zip(("nfe", "naccept", "nreject"), map(int, st1)))
    dist.destroy_process_group()
    if st1 != stats or not torch.equal(lp1, lp) or one.mesh[0] != (1, 1):
        fail(f"export mesh: the NCCL world of 1 served steps {st1} vs {stats}, or other bits")
    log(f"  export_logpdf(mesh=) on an NCCL world of 1: the unsharded served steps and bits ok")
    got = join_ranks("export", ranks)
    for r, g in enumerate(got):
        if g["stats"] != stats or g["rows"] != EXPORT_POINTS // EXPORT_RANKS:
            fail(f"export mesh: rank {r} served {g['rows']} rows with steps {g['stats']}, the "
                 f"unsharded call {stats}")
    mesh_err = compare(f"export_logpdf(mesh=) on {EXPORT_RANKS} gloo ranks, "
                       f"{EXPORT_POINTS // EXPORT_RANKS} points a rank, vs the unsharded served "
                       f"call", torch.cat([g["lp"] for g in got]), lp.cpu(), EXPORT_MESH_RTOL, 0.0)
    out["mesh"] = dict(stats=stats, max_abs_err=mesh_err,
                       export_s=[g["export_s"] for g in got])
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - started
    log(f"  [export] phase: {out['seconds']:.1f} s")
    record["export"] = out


def _plan_path(kind, n_in, h, nz):
    """K1's (``kind="fwd"``) or K2's path at these widths and IMAGE_BATCH."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    if kind == "fwd":
        return _build.fwd_plan(n_in, h, nz, nz, IMAGE_BATCH).path
    return _build.bwd_plan(n_in, h, nz, nz, 0, IMAGE_BATCH).path


class ProfileWindow:
    """``torch.profiler`` over a window of train steps, opened and closed by
    ``mark()`` at step ends (each synchronised): the device's busy ms, its
    kernels and idle share a step, and the all-reduce's device ms (NCCL's
    kernels) and host ms (the collective's host op, which is all of gloo's)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.times = []

    def mark(self):
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        if len(self.times) == 1:
            self.prof.__enter__()
        else:
            self.prof.__exit__(None, None, None)

    def summary(self, steps, named=None):
        """Per step; ``named``: {label: regular expression}, each adding
        ``<label>_ms``, the device ms of the kernels whose names match."""
        from torch.autograd import DeviceType

        events = self.prof.key_averages()
        host = {e.key for e in events if e.device_type == DeviceType.CPU}
        dev_ev = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in host]
        ms = lambda evs, attr="self_device_time_total": sum(
            getattr(e, attr) for e in evs) / 1e3 / steps
        busy = ms(dev_ev)
        step_ms = (self.times[1] - self.times[0]) * 1e3 / steps
        nccl = [e for e in dev_ev if "nccl" in e.key.lower()]
        collective = [e for e in events if e.device_type == DeviceType.CPU
                      and re.search(r"all_?reduce", e.key)]
        named_ms = {f"{k}_ms": ms([e for e in dev_ev if re.search(p, e.key)])
                    for k, p in (named or {}).items()}
        return dict(busy_ms=busy, step_ms=step_ms, idle_share=1.0 - busy / step_ms,
                    **named_ms, kernels=sum(e.count for e in dev_ev) / steps,
                    allreduce_device_ms=ms(nccl),
                    allreduce_kernels=sum(e.count for e in nccl) / steps,
                    allreduce_host_ms=max([ms([e], "cpu_time_total") for e in collective],
                                          default=0.0))


class ShardStepSpy:
    """Keeps every step ``ICNFModel`` makes by ``shard_train_step`` while
    entered; a step's ``counts`` are its last call's collectives by site."""

    def __enter__(self):
        from continuousnormalizingflows_tpu_torch.parallel import mesh as pmesh

        self.pmesh, self.inner, self.made = pmesh, pmesh.shard_train_step, []

        def spy(*a, **k):
            self.made.append(self.inner(*a, **k))
            return self.made[-1]

        pmesh.shard_train_step = spy
        return self

    def __exit__(self, *exc):
        self.pmesh.shard_train_step = self.inner


def sharded_grads(icnf, x, mesh, seed, tensor_parallel=False, reps=0):
    """One step of ``shard_train_step`` on this rank's rows of ``x``, with an
    optimizer that does not move the params: the global mean loss, the
    solve's stats, the gradients (with ``tensor_parallel``, of this rank's
    slices of the params, gathered whole), the launches and the
    collectives, and the sorted host seconds of ``reps`` more steps."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode
    from continuousnormalizingflows_tpu_torch.parallel import mesh as pmesh

    params = icnf.init(torch.Generator().manual_seed(0), device=x.device)
    if tensor_parallel:
        params = pmesh.shard_mlp_params(mesh, params)
    params = {k: v.requires_grad_() for k, v in params.items()}
    step = pmesh.shard_train_step(
        lambda p, g, xs, ys: cnf.loss_with_stats(icnf, Mode.TRAIN, xs, p, g), mesh,
        tensor_parallel=tensor_parallel)
    xl, _ = pmesh.shard_batch_arrays(mesh, x)
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    run = lambda: step(params, opt, torch.Generator(device=x.device).manual_seed(seed), xl, None)
    before = counts()
    loss, st = run()
    moved = {k: counts()[k] - before[k] for k in before}
    grads = {k: p.grad for k, p in params.items()}
    if tensor_parallel:
        grads = pmesh.gather_mlp_params(mesh, grads)
    return dict(loss=float(loss), stats=solve_stats(st), launches=moved,
                grads=[grads[k].detach().cpu() for k in params],
                collectives=dict(step.counts),
                seconds=sorted(host_seconds(run)[1] for _ in range(reps)))


def whole_grads(icnf, x, seed, reps=0):
    """:func:`sharded_grads`' step in one process on all of ``x``."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode

    params = icnf.init(torch.Generator().manual_seed(0), device=x.device)
    params = {k: v.requires_grad_() for k, v in params.items()}

    def run():
        for p in params.values():
            p.grad = None
        loss, st = cnf.loss_with_stats(icnf, Mode.TRAIN, x, params,
                                       torch.Generator(device=x.device).manual_seed(seed))
        loss.backward()
        return loss.detach(), st

    before = counts()
    loss, st = run()
    moved = {k: counts()[k] - before[k] for k in before}
    return dict(loss=float(loss), stats=solve_stats(st), launches=moved,
                grads=[p.grad.detach().cpu() for p in params.values()],
                seconds=sorted(host_seconds(run)[1] for _ in range(reps)))


def parallel_models():
    """The [parallel] phase's three paths: the digits-shaped model and data
    and its batch transform; the flagship's default adaptive stack; the
    same through K5 + K6."""
    import functools

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.utils import datasets as ds

    dev = torch.device("cuda")
    xd = ds.smooth_image_mixture(torch.Generator(device=dev).manual_seed(3), IMAGE_POINTS,
                                 DIGITS_SIDE)
    shift = functools.partial(ds.random_shift_images, side=DIGITS_SIDE, prob=0.5)
    x = ds.gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    return dict(digits=(image_model(DIGITS_SIDE, DIGITS_HIDDEN, fused=True), xd, shift),
                default=cnf.ICNF.create(nvariables=2),
                fused=cnf.ICNF.create(nvariables=2, fused=True, fused_adaptive=True), x=x)


def parallel_rank(rank, world, store, work):
    """A rank of the [parallel] phase's gloo runs, on the one card: the
    digits-shaped fit sharded ``world`` ways through K3 + K4 (its second
    and third steps profiled on rank 0), one step of the default adaptive
    stack and one of the fused adaptive route on 65,536 rows split over the
    ranks; its results to ``work/r<rank>.pt``, a failure's traceback to
    ``work/error_r<rank>.txt``."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        from continuousnormalizingflows_tpu_torch.parallel import initialize_distributed, make_mesh

        initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                               rank=rank, timeout=datetime.timedelta(seconds=PARALLEL_JOIN_S))
        mesh = make_mesh()
        m = parallel_models()
        icnf, xd, shift = m["digits"]
        profile = {} if rank == 0 else None
        with ShardStepSpy() as spy:
            res, rate, launched = image_fit(
                f"[rank {rank}] digits-shaped, {world} gloo ranks", icnf, xd, PARALLEL_RANK_STEPS,
                dict(NO_LAUNCH, K3=1, K4=1), torch.device("cuda"), batch_transform=shift,
                mesh=mesh, profile=profile)
        out = dict(history=res.history, rate=rate, launches=launched, profile=profile,
                   collectives=dict(spy.made[-1].counts),
                   params={k: v.cpu() for k, v in res.params.items()})
        out["default"] = sharded_grads(m["default"], m["x"], mesh, 11)
        out["fused"] = sharded_grads(m["fused"], m["x"], mesh, 11)
        torch.save(out, os.path.join(work, f"r{rank}.pt"))
        dist.destroy_process_group()
    except Exception:
        Path(work, f"error_r{rank}.txt").write_text(traceback.format_exc())
        raise


def start_ranks(target, world, work):
    """``target(rank, world, store, work)`` in ``world`` spawned processes
    that meet at a ``file://`` store under ``work``; each writes
    ``work/r<rank>.pt`` (a failure's traceback ``work/error_r<rank>.txt``).
    Returns what :func:`join_ranks` takes."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    # the store's path in a file:// URL must be absolute
    procs = [ctx.Process(target=target, args=(r, world, str((work / "store").resolve()),
                                              str(work)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, work, time.perf_counter()


def join_ranks(phase, started):
    """Join :func:`start_ranks`' processes within PARALLEL_JOIN_S of their
    start (a hung one is killed and fails the run); every rank's results,
    in order."""
    procs, work, t0 = started
    for p in procs:
        p.join(max(1.0, PARALLEL_JOIN_S - (time.perf_counter() - t0)))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [f.read_text() for f in sorted(work.glob("error_r*.txt"))]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        fail(f"{phase}: gloo ranks hung {hung}, exit codes {[p.exitcode for p in procs]}\n"
             + "\n".join(errors))
    log(f"  {len(procs)} gloo ranks on the card: joined in {time.perf_counter() - t0:.1f} s")
    return [torch.load(work / f"r{r}.pt") for r in range(len(procs))]


def parallel_phase(dev, record):
    """The parallel layer on the one card: (a) a world of 1 on NCCL
    (``initialize_distributed`` then ``make_mesh``) and the digits-shaped
    fit with ``mesh=`` through K3 + K4 against the unsharded fit, in turns:
    the same bits, the same launches, both rates by StepTimer, the
    collectives a step, and a profile of each; (b) 2 ranks on gloo, spawned,
    each on this card: the digits fit sharded 2 ways against the unsharded
    fit, and one step of the flagship's default adaptive stack and of its
    fused adaptive route (K5 + K6) on 65,536 rows (32,768 a rank) against
    one process on all of them: the same solver stats on both ranks and as
    one process's."""
    import shutil

    import torch.distributed as dist

    from continuousnormalizingflows_tpu_torch.parallel import initialize_distributed, make_mesh

    started = time.perf_counter()
    work = Path("chiprun_out") / "parallel_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    # (a) a world of 1 on NCCL
    initialize_distributed(backend="nccl", store=dist.HashStore(), world_size=1, rank=0)
    mesh = make_mesh()
    if dist.get_backend() != "nccl" or tuple(mesh.shape) != (1, 1):
        fail(f"parallel: world of 1 on {dist.get_backend()}, mesh {tuple(mesh.shape)}")
    m = parallel_models()
    icnf, xd, shift = m["digits"]
    want = dict(NO_LAUNCH, K3=1, K4=1)
    rates = {"unsharded": [], "mesh": []}
    fits = {}
    with ShardStepSpy() as spy:
        for turn in range(2):
            for name in ("unsharded", "mesh"):
                res, rate, launched = image_fit(
                    f"digits-shaped, {name} (NCCL world of 1), turn {turn}", icnf, xd,
                    IMAGE_FIT_STEPS, want, dev, batch_transform=shift,
                    mesh=mesh if name == "mesh" else None)
                rates[name].append(rate)
                fits[name] = (res, launched)
    (r_plain, l_plain), (r_mesh, l_mesh) = fits["unsharded"], fits["mesh"]
    if l_mesh != l_plain or l_mesh["K3"] == 0 or l_mesh["K4"] == 0:
        fail(f"parallel: the mesh fit launched {l_mesh}, the unsharded one {l_plain}")
    if r_mesh.history != r_plain.history or not all(
            torch.equal(r_mesh.params[k], r_plain.params[k]) for k in r_plain.params):
        fail("parallel: the NCCL world-of-1 fit's losses or params differ from the unsharded "
             "fit's bits")
    per_step = dict(spy.made[-1].counts)
    if per_step.get("grad") != 1 or set(per_step) != {"grad"}:
        fail(f"parallel: the digits step's collectives {per_step}, expected one gradient "
             f"all-reduce")
    log(f"  NCCL world of 1: the mesh fit gives the unsharded fit's bits (losses and params) "
        f"ok, launches {l_mesh} each; collectives a step {per_step}; train samples/s in turns: "
        f"unsharded {[round(v, 1) for v in rates['unsharded']]}, mesh "
        f"{[round(v, 1) for v in rates['mesh']]} ({nvidia_smi()})")
    profiles = {}
    for name in ("unsharded", "mesh"):
        profiles[name] = {}
        image_fit(f"digits-shaped, {name}, profiled", icnf, xd, 4, want, dev,
                  batch_transform=shift, mesh=mesh if name == "mesh" else None,
                  profile=profiles[name])
        log(f"  profile of a step, {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in profiles[name].items()))
    out["nccl_world_1"] = dict(rates=rates, launches=l_mesh, collectives=per_step,
                               profiles=profiles, same_bits=True)

    # the references of (b): one process on all the rows
    short, _rate, _l = image_fit("digits-shaped, unsharded, the 2-rank fit's steps", icnf, xd,
                                 PARALLEL_RANK_STEPS, want, dev, batch_transform=shift)
    whole = {name: whole_grads(m[name], m["x"], 11) for name in ("default", "fused")}
    if whole["fused"]["launches"]["K5"] != 1 or whole["fused"]["launches"]["K6"] != 1:
        fail(f"parallel: the fused adaptive reference launched {whole['fused']['launches']}")
    dist.destroy_process_group()
    del m, xd
    torch.cuda.empty_cache()

    # (b) 2 gloo ranks on the card
    world = 2
    got = join_ranks("parallel", start_ranks(parallel_rank, world, work))
    for r, g in enumerate(got):
        if g["launches"]["K3"] == 0 or g["launches"]["K4"] == 0:
            fail(f"parallel: rank {r}'s digits fit launched {g['launches']}")
        if g["collectives"] != {"grad": 1}:
            fail(f"parallel: rank {r}'s digits step collectives {g['collectives']}")
    hist = [g["history"] for g in got]
    if hist[0] != hist[1]:
        fail(f"parallel: the ranks logged other losses {hist}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(hist[0], short.history))
    if loss_err > PARALLEL_LOSS_RTOL:
        fail(f"parallel: the 2-rank digits fit's losses {hist[0]} vs one process's "
             f"{short.history} (rtol {loss_err:.2e} > {PARALLEL_LOSS_RTOL})")
    p_err = compare_to_max("2 gloo ranks' digits-shaped params vs one process's after "
                           f"{PARALLEL_RANK_STEPS} steps",
                           [got[0]["params"][k] for k in short.params],
                           [short.params[k].cpu() for k in short.params], PARALLEL_PARAM_TOL)
    if not all(torch.equal(got[1]["params"][k], got[0]["params"][k]) for k in short.params):
        fail("parallel: the ranks' digits params differ")
    log(f"  2-rank digits fit: losses equal on both ranks, rtol {loss_err:.2e} against one "
        f"process's; {[round(g['rate'], 1) for g in got]} train samples/s a rank; profile of "
        f"a step on rank 0: " + ", ".join(f"{k} {v:.4f}" for k, v in got[0]["profile"].items()))
    checks = {}
    for name in ("default", "fused"):
        ranks_ = [g[name] for g in got]
        if ranks_[0]["stats"] != ranks_[1]["stats"] or ranks_[0]["stats"] != whole[name]["stats"]:
            fail(f"parallel {name}: solver stats {[r['stats'] for r in ranks_]} vs one "
                 f"process's {whole[name]['stats']}")
        if name == "fused" and any(r["launches"]["K5"] != 1 or r["launches"]["K6"] != 1
                                   for r in ranks_):
            fail(f"parallel fused: launches {[r['launches'] for r in ranks_]}, expected K5 and "
                 f"K6 on each rank")
        if name == "default" and any(r["launches"] != NO_LAUNCH for r in ranks_):
            fail(f"parallel default: launches {[r['launches'] for r in ranks_]}")
        if abs(ranks_[0]["loss"] - whole[name]["loss"]) > PARALLEL_LOSS_RTOL * abs(
                whole[name]["loss"]) or ranks_[0]["loss"] != ranks_[1]["loss"]:
            fail(f"parallel {name}: loss {[r['loss'] for r in ranks_]} vs {whole[name]['loss']}")
        err = compare_to_max(f"{name} stack on 2 gloo ranks vs one process, 65,536 rows, "
                             f"steps {whole[name]['stats']}: the parameter gradients",
                             ranks_[0]["grads"], whole[name]["grads"], GRAD_TOL)
        checks[name] = dict(stats=whole[name]["stats"], grad_max_abs_err=err,
                            launches=[r["launches"] for r in ranks_],
                            collectives=ranks_[0]["collectives"])
        log(f"  {name}: the same stats {whole[name]['stats']} on both ranks and as one process; "
            f"launches a rank {ranks_[0]['launches']}; collectives {ranks_[0]['collectives']}")
    out["gloo_2_ranks"] = dict(history=hist[0], loss_rtol=loss_err, params_max_abs_err=p_err,
                               rates=[g["rate"] for g in got], profile=got[0]["profile"],
                               launches=[g["launches"] for g in got], checks=checks)
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - started
    log(f"  [parallel] phase: {out['seconds']:.1f} s")
    record["parallel"] = out


def model_axis_models(dev):
    """[model axis]'s paths at the digits widths (65 -> 256 -> 256 -> 64) and
    their 256 points: ``tp`` the default stack without the seminorm
    (``SolverConfig(adjoint_seminorm=False)``), ``fused=True``, bf16
    products (K1 + K2 on the net gathered); ``probe`` rk4-24 with 2 probes
    split over ``model`` (no fused gate takes 2 probes) and fp32 products
    (autograd rounds a bf16 product's cotangents to bf16, and the ranks'
    cotangents are summed in another order than one process's: ~7e-4 of the
    largest gradient apart in bf16, measured on the CPU); ``sweep`` the fp32
    eval twin (dopri5 1e-4) behind ``from_torch``, whose TEST trace is the
    exact sweep, split over ``model`` in chunks of MODEL_AXIS_SWEEP_CHUNK
    basis rows."""
    import dataclasses

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import SolverConfig
    from continuousnormalizingflows_tpu_torch.utils import datasets as ds

    rk4 = image_model(DIGITS_SIDE, DIGITS_HIDDEN)
    ev = export_eval_model(SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4))
    return dict(
        x=ds.smooth_image_mixture(torch.Generator(device=dev).manual_seed(8), IMAGE_BATCH,
                                  DIGITS_SIDE),
        tp=image_model(DIGITS_SIDE, DIGITS_HIDDEN, fused=True,
                       solver=SolverConfig(adjoint_seminorm=False)),
        probe=cnf.ICNF(dataclasses.replace(rk4.config, nprobes=2, probe_axis="model"),
                       cnf.MLP(rk4.net.widths, precision="highest")),
        sweep=cnf.ICNF(dataclasses.replace(ev.config, sweep_axis="model",
                                           exact_chunk=MODEL_AXIS_SWEEP_CHUNK),
                       cnf.from_torch(ev.net, ev.net.n_in, ev.net.n_out)))


def model_axis_sweep(icnf, x, mesh=None):
    """TEST inference of ``icnf`` on ``x``: with ``mesh``, on this rank's
    slices of the params with the exact sweep split over ``model``."""
    import contextlib

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode
    from continuousnormalizingflows_tpu_torch.parallel import mesh as pmesh

    params = icnf.init(torch.Generator().manual_seed(0), device=x.device)
    if mesh is not None:
        params = pmesh.shard_mlp_params(mesh, params)
    ctx = (pmesh.use_mesh(mesh, tensor_parallel=True) if mesh is not None
           else contextlib.nullcontext())
    reset_counts()
    with ctx as shards, torch.no_grad():
        lp, _augs, st = cnf.inference(icnf, Mode.TEST, x, params)
    return dict(lp=lp.cpu(), stats=solve_stats(st), launches=counts(),
                collectives=dict(shards.counts) if shards is not None else {})


def model_axis_rank(rank, world, store, work):
    """A rank of [model axis]'s 1 x ``world`` mesh of gloo ranks on the one
    card: the three paths of :func:`model_axis_models` on its slices of the
    net; its results to ``work/r<rank>.pt``, a failure's traceback to
    ``work/error_r<rank>.txt``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        dev = torch.device(torch.load(Path(work) / "inputs.pt")["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        from continuousnormalizingflows_tpu_torch.parallel import (initialize_distributed,
                                                                   make_mesh, shard_batch_arrays)

        initialize_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                               rank=rank, timeout=datetime.timedelta(seconds=PARALLEL_JOIN_S))
        mesh = make_mesh(data=1, model=world, device=dev)
        m = model_axis_models(dev)
        x, _ = shard_batch_arrays(mesh, m["x"])
        out = dict(tp=sharded_grads(m["tp"], x, mesh, 11, True, MODEL_AXIS_REPS),
                   probe=sharded_grads(m["probe"], x, mesh, 11, True),
                   sweep=model_axis_sweep(m["sweep"], x, mesh))
        torch.save(out, Path(work) / f"r{rank}.pt")
        dist.destroy_process_group()
    except Exception:
        Path(work, f"error_r{rank}.txt").write_text(traceback.format_exc())
        raise


def model_axis_phase(dev, record):
    """The model axis in full on the one card.  (a) 2 gloo ranks, a 1 x 2
    mesh, the digits-shaped net split 128 + 128 on the default stack without
    the seminorm, ``fused=True``: one ``shard_train_step(tensor_parallel=True)``
    step against one process on the whole net (the same draws): the same
    solver stats on both ranks and as one process, the loss within
    PARALLEL_LOSS_RTOL, the gradients within GRAD_TOL of their largest
    entry, and each rank's K1 and K2 launches one process's (both on their
    wide paths); the error norms' all-reduces a step and the step's rate.
    (b) On the same ranks: the 2-probe rk4 step with the probes split over
    ``model`` and the TEST exact sweep split over ``model``, each against
    one process.  (c) ``graft_entry.dryrun_multichip(4)`` on the card. (d) A
    float64 ``fused=True`` rk4 and ``fused_adaptive`` loss and gradient:
    no kernel, finite float64.  (e) ``usage.py`` at a few epochs, in a
    process of its own beside (c) and (d)."""
    import shutil

    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.graft_entry import dryrun_multichip

    started = time.perf_counter()
    work = Path("chiprun_out") / "model_axis_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    # one process on the whole net: the references of (a) and (b)
    m = model_axis_models(dev)
    one = dict(tp=whole_grads(m["tp"], m["x"], 11, MODEL_AXIS_REPS),
               probe=whole_grads(m["probe"], m["x"], 11),
               sweep=model_axis_sweep(m["sweep"], m["x"]))
    side, h = DIGITS_SIDE, DIGITS_HIDDEN
    paths = (_plan_path("fwd", side * side + 1, h, side * side),
             _plan_path("bwd", side * side + 1, h, side * side))
    if paths != ("wide", "wide"):
        fail(f"model axis: K1 and K2 take the {paths} paths at the digits widths")
    if (one["tp"]["launches"]["K1"] == 0 or one["tp"]["launches"]["K2"] == 0
            or any(one["tp"]["launches"][k] for k in ("K3", "K4", "K5", "K6"))):
        fail(f"model axis: one process's default-stack step launched {one['tp']['launches']}")
    for name in ("probe", "sweep"):
        if one[name]["launches"] != NO_LAUNCH:
            fail(f"model axis: one process's {name} path launched {one[name]['launches']}")
    del m
    torch.cuda.empty_cache()

    # (a) and (b) on 2 gloo ranks
    torch.save({"device": str(dev)}, work / "inputs.pt")
    got = join_ranks("model axis", start_ranks(model_axis_rank, MODEL_AXIS_RANKS, work))
    ref = one["tp"]
    for r, g in enumerate(got):
        tp = g["tp"]
        if tp["stats"] != ref["stats"] or tp["launches"] != ref["launches"]:
            fail(f"model axis (a): rank {r}'s stats {tp['stats']} and launches {tp['launches']} "
                 f"vs one process's {ref['stats']} and {ref['launches']}")
        if abs(tp["loss"] - ref["loss"]) > PARALLEL_LOSS_RTOL * abs(ref["loss"]):
            fail(f"model axis (a): rank {r}'s loss {tp['loss']} vs one process's {ref['loss']}")
    if got[0]["tp"]["collectives"] != got[1]["tp"]["collectives"]:
        fail(f"model axis (a): the ranks issued other collectives "
             f"{[g['tp']['collectives'] for g in got]}")
    err = compare_to_max("(a) the tensor-parallel default-stack step (2 model ranks) vs one "
                         "process: the gradients", got[0]["tp"]["grads"], ref["grads"], GRAD_TOL)
    rate = lambda secs: IMAGE_BATCH / statistics.median(secs)
    rates = dict(one_process=rate(ref["seconds"]), ranks=[rate(g["tp"]["seconds"]) for g in got])
    coll = got[0]["tp"]["collectives"]
    log(f"  (a) stats {ref['stats']} on both ranks and as one process; K1 {ref['launches']['K1']}"
        f" and K2 {ref['launches']['K2']} launches a rank, one process's, on their wide paths; "
        f"collectives a step {coll} ({coll.get('norm', 0)} error-norm all-reduces); train "
        f"samples/s one process {rates['one_process']:.1f}, a rank "
        f"{[round(v, 1) for v in rates['ranks']]} ({nvidia_smi()})")
    out["tp"] = dict(stats=ref["stats"], launches=ref["launches"], collectives=coll,
                     loss=ref["loss"], grad_max_abs_err=err, rates=rates,
                     seconds=dict(one_process=ref["seconds"],
                                  ranks=[g["tp"]["seconds"] for g in got]))
    pr = one["probe"]
    for r, g in enumerate(got):
        if g["probe"]["stats"] != pr["stats"] or abs(g["probe"]["loss"] - pr["loss"]) > (
                PARALLEL_LOSS_RTOL * abs(pr["loss"])) or g["probe"]["launches"] != NO_LAUNCH:
            fail(f"model axis (b): rank {r}'s 2-probe step {g['probe']['stats']}, loss "
                 f"{g['probe']['loss']}, launches {g['probe']['launches']} vs one process's "
                 f"{pr['stats']}, {pr['loss']}")
    p_err = compare_to_max("(b) the 2-probe rk4 step, probes and MLP split over model, vs one "
                           "process: the gradients", got[0]["probe"]["grads"], pr["grads"],
                           GRAD_TOL)
    sw = one["sweep"]
    if any(g["sweep"]["stats"] != sw["stats"] for g in got):
        fail(f"model axis (b): the sweep's steps {[g['sweep']['stats'] for g in got]} vs one "
             f"process's {sw['stats']}")
    s_err = compare(f"(b) TEST exact sweep split over model (chunks of {MODEL_AXIS_SWEEP_CHUNK}, "
                    f"steps {tuple(sw['stats'].values())}) vs one process",
                    [g["sweep"]["lp"] for g in got], [sw["lp"]] * len(got),
                    *MODEL_AXIS_SWEEP_TOL)
    out["probe"] = dict(stats=pr["stats"], grad_max_abs_err=p_err,
                        collectives=got[0]["probe"]["collectives"])
    out["sweep"] = dict(stats=sw["stats"], lp_max_abs_err=s_err,
                        collectives=got[0]["sweep"]["collectives"])
    log(f"  (b) the 2-probe step's collectives {got[0]['probe']['collectives']}; the sweep's "
        f"{got[0]['sweep']['collectives']}")

    # (e) usage.py in a process of its own, beside (c) and (d)
    usage_out = (Path("chiprun_out") / "usage").resolve()
    shutil.rmtree(usage_out, ignore_errors=True)
    usage_log = work / "usage.log"
    t_usage = time.perf_counter()
    with open(usage_log, "w") as f:
        usage = subprocess.Popen(
            [sys.executable, "-m", "continuousnormalizingflows_tpu_torch.usage", "--out",
             str(usage_out), "--epochs", str(MODEL_AXIS_USAGE_EPOCHS), "--device", dev.type],
            stdout=f, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)
    try:
        # (c) graft_entry's dryrun on the card
        dry = dryrun_multichip(DRYRUN_RANKS, device=dev.type)
        by = {tuple(r["coord"]): r for r in dry["ranks"]}
        if len({r["loss"] for r in dry["ranks"]}) != 1 or any(
                not torch.equal(by[(d, 0)]["lp"], by[(d, 1)]["lp"]) for d in (0, 1)):
            fail(f"model axis (c): the dryrun's ranks disagree: {dry['ranks']}")
        log(f"  (c) dryrun_multichip({DRYRUN_RANKS}) on {dry['backend']} "
            f"({torch.cuda.device_count()} card(s)): {dry['seconds']:.1f} s; loss "
            f"{dry['ranks'][0]['loss']:.4f}, carried fit {dry['ranks'][0]['carry_loss']:.4f}, "
            f"the sharded sweep's logp finite ok")
        out["dryrun"] = dict(backend=dry["backend"], seconds=dry["seconds"],
                             loss=dry["ranks"][0]["loss"])

        # (d) float64 with fused=True: the unfused route, no kernel
        out["float64"] = {}
        for name, solver, kw in (
                ("rk4", SolverConfig(method="rk4", gradient="backprop", fixed_steps=STEPS), {}),
                ("fused_adaptive", SolverConfig(), dict(fused_adaptive=True))):
            icnf = cnf.ICNF.create(nvariables=2, dtype=torch.float64, fused=True, solver=solver,
                                   **kw)
            params = {k: v.requires_grad_() for k, v in icnf.init(
                torch.Generator().manual_seed(0), device=dev).items()}
            x64 = 0.5 * torch.randn((IMAGE_BATCH, 2), dtype=torch.float64, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(12))
            reset_counts()
            loss = cnf.loss(icnf, Mode.TRAIN, x64, params,
                            torch.Generator(device=dev).manual_seed(13))
            loss.backward()
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(loss)) and all(
                p.grad is not None and p.grad.dtype == torch.float64
                and bool(torch.isfinite(p.grad).all()) for p in params.values())
            if counts() != NO_LAUNCH or loss.dtype != torch.float64 or not finite:
                fail(f"model axis (d): float64 fused=True {name}: launches {counts()}, loss "
                     f"{loss}")
            out["float64"][name] = float(loss.detach())
        log(f"  (d) float64 fused=True, rk4 and fused_adaptive: no kernel launched, float64 "
            f"losses {out['float64']} ok")
        usage.wait(timeout=max(1.0, PARALLEL_JOIN_S - (time.perf_counter() - t_usage)))
    finally:
        if usage.poll() is None:
            usage.kill()
            usage.wait()
    tail = usage_log.read_text().strip().splitlines()[-3:]
    res = json.loads((usage_out / "usage.json").read_text()) if usage.returncode == 0 else {}
    if usage.returncode != 0 or not res.get("served_matches"):
        fail(f"model axis (e): usage.py exited {usage.returncode}: {tail}")
    log(f"  (e) usage.py --epochs {MODEL_AXIS_USAGE_EPOCHS}: {time.perf_counter() - t_usage:.1f} "
        f"s (" + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items()) + "); final loss "
        f"{res['final_loss']:.4f}, served logp within {res['served_max_abs_diff']:.3e} of "
        f"log_prob ok")
    out["usage"] = res
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - started
    log(f"  [model axis] phase: {out['seconds']:.1f} s")
    record["model_axis"] = out


def device_profile(fn) -> dict:
    """``fn()`` once under ``torch.profiler`` with CUDA activity only, read
    from the profiler's raw events (the per-op host records ProfileWindow
    keeps take tens of seconds to process at ~40,000 kernels a step): the
    device's busy ms (kernels, copies and fills), the call's host ms, the
    idle share and the device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    ns = lambda e: e.duration_ns() if hasattr(e, "duration_ns") else 1e3 * e.duration_us()
    busy = sum(ns(e) for e in dev) / 1e6
    return dict(busy_ms=busy, step_ms=step_ms, idle_share=1.0 - busy / step_ms, kernels=len(dev))


def layout_model(layout, precision="highest", fused=False, solver=None):
    """The JAX package's ``benchmarks/layout_ab.py`` model: the flagship
    (``ICNF.create(nvariables=2)``, 6 -> 24 -> 24 -> 5), rk4-32 with backprop
    unless ``solver`` is given."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import SolverConfig

    solver = solver or SolverConfig(method="rk4", gradient="backprop", fixed_steps=STEPS)
    return cnf.ICNF.create(nvariables=2, solver=solver, precision=precision, layout=layout,
                           fused=fused)


def layout_exports(dev, x, out):
    """The default stack's feature-first TEST log-density and a from_torch
    ``nn.Sequential`` at the flagship widths (its exact trace through the fx
    graph), each exported (``_export_logpdf``, the symbolic batch) and served
    on ``x`` against its eager call: equal steps, LAYOUT_EXPORT_RTOL, no
    kernel."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import ICNFConfig, Mode
    from continuousnormalizingflows_tpu_torch.utils import export as ex

    cfg = ICNFConfig(nvariables=2)
    module = torch.nn.Sequential(torch.nn.Linear(cfg.n_in, 24), torch.nn.Softplus(),
                                 torch.nn.Linear(24, 24), torch.nn.Softplus(),
                                 torch.nn.Linear(24, cfg.n_out))
    models = {"feature-first default stack": cnf.ICNF.create(nvariables=2, layout="feature_first"),
              "from_torch Sequential, default stack": cnf.ICNF(
                  cfg, cnf.from_torch(module, cfg.n_in, cfg.n_out))}
    for name, icnf in models.items():
        params = icnf.init(torch.Generator().manual_seed(0), device=dev)
        reset_counts()
        art, export_s = host_seconds(lambda: ex._export_logpdf(icnf, params, device=dev))
        (lp, nfe, nacc, nrej), served_s = host_seconds(lambda: art.call(x))
        with torch.no_grad():
            (eager, _a, st), eager_s = host_seconds(
                lambda: cnf.inference(icnf, Mode.TEST, x, params))
        stats = {"nfe": int(nfe), "naccept": int(nacc), "nreject": int(nrej)}
        if stats != solve_stats(st):
            fail(f"[layout] {name}: the served call's steps {stats} vs eager {solve_stats(st)}")
        if counts() != NO_LAUNCH:
            fail(f"[layout] {name}: the TEST calls launched kernels {counts()}")
        if lp.shape != (x.shape[0],) or not torch.isfinite(lp).all():
            fail(f"[layout] {name}: served log-density shape {tuple(lp.shape)} or non-finite")
        err = compare(f"[layout] {name}: served vs eager TEST log-density", lp, eager,
                      LAYOUT_EXPORT_RTOL, 0.0)
        log(f"  {name}: exported in {export_s:.1f} s; {x.shape[0]} points served in "
            f"{served_s * 1e3:.1f} ms, eager {eager_s * 1e3:.1f} ms; steps {tuple(stats.values())} "
            f"equal ok")
        out[name] = dict(export_s=export_s, served_ms=served_s * 1e3, eager_ms=eager_s * 1e3,
                         max_abs_err=err, **stats)


def layout_phase(dev, record):
    """[layout]: ``layout="feature_first"`` on the JAX package's own A/B,
    ``benchmarks/layout_ab.py`` as it stands (the flagship, rk4-32 with
    backprop, B = 65,536 ``gaussian_mixture`` points, Adam at 1e-3), for each
    precision ("default": bf16-rounded operands; "highest") both layouts from
    the same params with the same draws, one warm-up step then LAYOUT_STEPS
    timed steps each in turns, then one profiled step each.  Checks: each
    step's feature-first loss against the batch-first one (LAYOUT_LOSS_ATOL),
    the first step's gradients (LAYOUT_GRAD_TOL of each tensor's largest), no
    kernel launched on any step (a feature-first step with ``fused=True``
    too, whose loss is the unfused one's bits); the default stack (dopri5 at
    1e-4, backsolve) on the same points takes equal NFE and steps in both
    layouts; layout_exports."""
    import continuousnormalizingflows_tpu_torch as cnf
    from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    started = time.perf_counter()
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), BATCH)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    out, parts = {}, {}
    for prec in ("default", "highest"):
        t_prec = time.perf_counter()
        state = {}
        for lay in LAYOUTS:
            icnf = layout_model(lay, prec)
            p = {k: v.requires_grad_() for k, v in icnf.init(
                torch.Generator().manual_seed(0), device=dev).items()}
            state[lay] = (icnf, p, torch.optim.Adam(list(p.values()), lr=1e-3))
        icnf_ff, p_ff, _opt = state["feature_first"]
        reset_counts()
        with torch.no_grad():
            fused_ff = cnf.loss(layout_model("feature_first", prec, fused=True), Mode.TRAIN, x,
                                p_ff, gen(99))
            plain_ff = cnf.loss(icnf_ff, Mode.TRAIN, x, p_ff, gen(99))
        if counts() != NO_LAUNCH or not torch.equal(fused_ff, plain_ff):
            fail(f"[layout] {prec}: feature-first with fused=True launched {counts()} or its "
                 f"loss {float(fused_ff)} is not the unfused one's {float(plain_ff)}")

        def step(lay, seed):
            icnf, p, opt = state[lay]
            opt.zero_grad(set_to_none=True)
            loss = cnf.loss(icnf, Mode.TRAIN, x, p, gen(seed))
            loss.backward()
            grads = {k: v.grad.detach().clone() for k, v in p.items()}
            opt.step()
            return loss.detach(), grads

        runs, first = {lay: [] for lay in LAYOUTS}, {}
        for i in range(LAYOUT_STEPS + 1):  # step 0 warms up, untimed
            for lay in (LAYOUTS if i % 2 == 0 else LAYOUTS[::-1]):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, grads = step(lay, 100 + i)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if counts() != NO_LAUNCH:
                    fail(f"[layout] {prec} {lay} step {i}: launches {counts()}")
                if not torch.isfinite(loss) or not all(torch.isfinite(g).all()
                                                       for g in grads.values()):
                    fail(f"[layout] {prec} {lay} step {i}: non-finite loss or gradient")
                if i == 0:
                    first[lay] = grads
                runs[lay].append(dict(ms=ms, loss=float(loss)))
        gap = max(abs(f["loss"] - b["loss"])
                  for f, b in zip(runs["feature_first"], runs["batch_first"]))
        if gap > LAYOUT_LOSS_ATOL:
            fail(f"[layout] {prec}: feature-first and batch-first losses differ by {gap:.3e} "
                 f"at some step (bound {LAYOUT_LOSS_ATOL})")
        compare_to_max(f"[layout] {prec}: the first step's gradients, feature-first vs "
                       f"batch-first", list(first["feature_first"].values()),
                       list(first["batch_first"].values()), LAYOUT_GRAD_TOL)
        summary = {}
        for lay in LAYOUTS:
            prof = device_profile(lambda: step(lay, 200))
            ms = sorted(r["ms"] for r in runs[lay][1:])
            summary[lay] = dict(ms_median=statistics.median(ms), ms_min=ms[0], ms_max=ms[-1],
                                losses=[r["loss"] for r in runs[lay]], profile=prof)
            log(f"  {prec} {lay}: {statistics.median(ms):.3f} ms a step (median of {len(ms)}, "
                f"min {ms[0]:.3f}, max {ms[-1]:.3f}), {BATCH / statistics.median(ms) * 1e3:.1f} "
                f"train samples/s; profiled step: device busy {prof['busy_ms']:.3f} ms of "
                f"{prof['step_ms']:.3f}, idle share {prof['idle_share']:.3f}, "
                f"{prof['kernels']:.0f} kernels")
        ratio = summary["feature_first"]["ms_median"] / summary["batch_first"]["ms_median"]
        log(f"  {prec}: losses within {gap:.2e} a step (bound {LAYOUT_LOSS_ATOL}) ok; no kernel "
            f"on any step, fused=True included, ok; feature-first {ratio:.3f}x the batch-first "
            f"ms a step ({nvidia_smi()})")
        out[prec] = dict(loss_gap=gap, ff_over_bf=ratio, **summary)
        parts[prec] = time.perf_counter() - t_prec
    # the default stack: equal steps in both layouts
    t_stack = time.perf_counter()
    stack = {}
    p0 = None
    for lay in LAYOUTS:
        icnf = layout_model(lay, solver=SolverConfig())
        p0 = p0 or icnf.init(torch.Generator().manual_seed(0), device=dev)
        p = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
        reset_counts()
        loss, st = cnf.loss_with_stats(icnf, Mode.TRAIN, x, p, gen(7))
        grads = torch.autograd.grad(loss, list(p.values()))
        if counts() != NO_LAUNCH:
            fail(f"[layout] default stack {lay}: launches {counts()}")
        stack[lay] = dict(loss=float(loss.detach()), grads=grads, **solve_stats(st))
    steps = {lay: tuple(stack[lay][k] for k in ("nfe", "naccept", "nreject")) for lay in LAYOUTS}
    if steps["feature_first"] != steps["batch_first"]:
        fail(f"[layout] default stack: steps (NFE, accepted, rejected) {steps}")
    if abs(stack["feature_first"]["loss"] - stack["batch_first"]["loss"]) > LAYOUT_LOSS_ATOL:
        fail(f"[layout] default stack: losses {stack['feature_first']['loss']} vs "
             f"{stack['batch_first']['loss']}")
    compare_to_max("[layout] default stack: gradients, feature-first vs batch-first",
                   list(stack["feature_first"]["grads"]), list(stack["batch_first"]["grads"]),
                   LAYOUT_GRAD_TOL)
    log(f"  default stack (dopri5, 1e-4, backsolve), {BATCH} points: (NFE, accepted, rejected) "
        f"{steps['feature_first']} in both layouts ok")
    out["default_stack"] = {lay: {k: v for k, v in d.items() if k != "grads"}
                            for lay, d in stack.items()}
    parts["default stack"] = time.perf_counter() - t_stack
    out["export"] = {}
    t_export = time.perf_counter()
    layout_exports(dev, x, out["export"])
    parts["exports"] = time.perf_counter() - t_export
    out["seconds"], out["part_seconds"] = time.perf_counter() - started, parts
    log(f"  [layout] phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    record["layout"] = out


def main() -> None:
    started = time.perf_counter()
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
    entry = ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = kernel_label(line.split("'")[1] if "'" in line else line)
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {entry}: {line.strip()}")
    record["build_seconds"] = info["seconds"]

    log("[kernels] each kernel vs its plain PyTorch version")
    results = kernel_phase(dev, record)
    adaptive_results = adaptive_kernel_phase(dev, record)
    log("[slice] flagship RNODE, fused=True, 65,536 samples, rk4-32")
    launches = slice_phase(dev, record)
    log("[train] ICNFModel.fit, batch 65,536, rk4-32: the flagship RNODE (K3 + K4) and "
        "its FFJORD form (K1 + K2)")
    train = train_phase(dev, record)
    for path, want in (("rnode", ("K3", "K4")), ("ffjord", ("K1", "K2"))):
        if any(train[path][k] == 0 for k in want):
            fail(f"train {path}: a kernel of the path was not launched: {train[path]}")
    log("[adaptive] flagship RNODE, the default SolverConfig (dopri5, rtol = atol = 1e-4, "
        "HNW start, backsolve adjoint), fused=False, 65,536 samples")
    adaptive_phase(dev, record)
    log("[adaptive fused] fused=True, fused_adaptive=True: K5 forward, K6 backward")
    fused_adaptive = adaptive_fused_phase(dev, record)
    log("[adaptive band] the JAX package's adaptive band (benchmarks/adaptive_band.py, "
        "h=128 d=20: ICNFConfig(nvariables=20), 42 -> 128 -> 128 -> 41, dopri5 at 1e-4, "
        f"adjoint), batch {' and '.join(f'{b:,}' for b in BAND_BATCHES)}: {BAND_STEPS} TRAIN "
        "loss-and-gradient steps at fixed params, fused (K5 + K6) and unfused in turns")
    band, band_k = band_phase(dev, record)
    log("[abm] flagship RNODE, SolverConfig(method='abm', rtol = atol = 1e-4, "
        "gradient='quadrature'), 65,536 samples: unfused, and fused (K1 + K2)")
    abm_phase(dev, record)
    log("[nets] Planar, the exact sweep, HUTCH_JVP, CondLayer, from_torch, custom "
        "distributions, 65,536 samples, against the CPU on 256 points")
    nets_phase(dev, record)
    log("[image] the utils layer on the image-scale FFJORD path (d = 784, 785 -> 1024 -> 1024 "
        "-> 784, batch 256, K1 + K2) and the digits-shaped path (65 -> 256 -> 256 -> 64, "
        "K3 + K4): datasets, StepTimer, profiling.trace, AsyncCheckpointer, export")
    image_phase(dev, record)
    log("[export] the rest of the serving export at the digits widths (65 -> 256 -> 256 -> "
        "64): a fit on the default stack (abm + quadrature, K1 + K2) and its abm eval twin "
        "served; the written-out exact sweep and a gelu net; a Student-t sampler; "
        "export_logpdf(mesh=) on an NCCL world of 1 and 2 gloo ranks")
    export_phase(dev, record)
    log("[parallel] the parallel layer: a world of 1 on NCCL (the digits-shaped fit with "
        "mesh=, K3 + K4, against the unsharded fit) and 2 gloo ranks on the card (the digits "
        "fit, the default adaptive stack and K5 + K6 on 65,536 rows)")
    parallel_phase(dev, record)
    log("[model axis] the model axis in full at the digits widths (65 -> 256 -> 256 -> 64, "
        "B = 256) on 2 gloo ranks, h = 256 split 128 + 128: the default stack without the "
        "seminorm through K1 + K2, the 2-probe rk4 step, the TEST exact sweep; "
        "dryrun_multichip(4); float64 with fused=True; usage.py")
    model_axis_phase(dev, record)
    log("[layout] layout='feature_first' on the JAX package's benchmarks/layout_ab.py (the "
        "flagship, rk4-32 backprop, B = 65,536, Adam at 1e-3), precision default and highest, "
        "against batch_first in turns; the default stack's steps; the exported feature-first "
        "and from_torch exact TEST log-densities")
    layout_phase(dev, record)
    log(f"[done] every phase passed, {time.perf_counter() - started:.1f} s in all")

    flag = {r["precision"]: r for r in results if r["shape"] == "flagship"}["fp32"]
    ad = {r["shape"]: r for r in adaptive_results}["flagship"]
    # K5's and K6's cluster path on [adaptive band]'s own inputs at its first
    # batch (16,384): times, errors and bounds (band_kernels), with the
    # launches of both of its batches
    bd_bounds = kernel_bounds(*(band_k["widths"][i] for i in (0, 1, 3)), band_k["batch"],
                              band_k["nfe_rows"], band_k["accepted_rows"])
    bounds = kernel_bounds(*(flag["widths"][i] for i in (0, 1, 3)), flag["batch"],
                           ad["nfe_rows"], ad["accepted_rows"])
    # K1's and K2's wide paths at the image fit's widths, batch and precision (bf16)
    img = {(r["shape"], r["precision"]): r for r in record["image_path_widths"]}[("image", "bf16")]
    img_bounds = kernel_bounds(*(img["widths"][i] for i in (0, 1, 3)), img["batch"],
                               cdt=torch.bfloat16)
    # K3's and K4's wide paths at the digits-shaped fit's widths, batch, steps
    # and precision (bf16)
    dig = {(r["shape"], r["precision"]): r
           for r in record["image_path_widths"]}[("digits", "bf16")]
    dig_bounds = kernel_bounds(*(dig["widths"][i] for i in (0, 1, 3)), dig["batch"],
                               steps=IMAGE_RK4_STEPS, cdt=torch.bfloat16)
    digits_fit = record["image"]["digits"]["launches"]
    # K1's and K2's wide paths at the digits widths, batch and precision (bf16),
    # with the launches of [export]'s default-stack digits fit
    dst = {(r["shape"], r["precision"]): r
           for r in record["image_path_widths"]}[("digits_stage", "bf16")]
    dst_bounds = kernel_bounds(*(dst["widths"][i] for i in (0, 1, 3)), dst["batch"],
                               cdt=torch.bfloat16)
    default_fit = record["export"]["fit"]["launches"]
    rows = [  # (K, name, source file, TPU kernel, launches on the main path, results, bounds)
        ("K1", "fused_dynamics_fwd", "fused_dynamics.cu", "pallas_kernels.py:118",
         launches["K1"], flag, bounds),
        ("K3", "fused_solve_rk4_fwd", "fused_solve.cu", "pallas_solve.py:176", launches["K3"],
         flag, bounds),
        ("K2", "fused_dynamics_bwd", "fused_dynamics_bwd.cu", "pallas_kernels.py:182",
         train["ffjord"]["K2"], flag, bounds),
        ("K2", "fused_dynamics_bwd, wide path (image fit, bf16)", "wide_stage_bwd.cuh",
         "pallas_kernels.py:182", record["image"]["fit"]["launches"]["K2"], img, img_bounds),
        ("K1", "fused_dynamics_fwd, wide path (image fit, bf16)", "wide_stage_fwd.cuh",
         "pallas_kernels.py:118", record["image"]["fit"]["launches"]["K1"], img, img_bounds),
        ("K4", "fused_solve_rk4_bwd", "fused_solve_bwd.cu", "pallas_solve.py:206",
         train["rnode"]["K4"], flag, bounds),
        ("K4", "fused_solve_rk4_bwd, wide path (digits-shaped fit, bf16)", "wide_solve.cuh",
         "pallas_solve.py:206", digits_fit["K4"], dig, dig_bounds),
        ("K3", "fused_solve_rk4_fwd, wide path (digits-shaped fit, bf16)", "wide_solve.cuh",
         "pallas_solve.py:176", digits_fit["K3"], dig, dig_bounds),
        ("K1", "fused_dynamics_fwd, wide path (digits-shaped default-stack fit, bf16)",
         "wide_stage_fwd.cuh", "pallas_kernels.py:118", default_fit["K1"], dst, dst_bounds),
        ("K2", "fused_dynamics_bwd, wide path (digits-shaped default-stack fit, bf16)",
         "wide_stage_bwd.cuh", "pallas_kernels.py:182", default_fit["K2"], dst, dst_bounds),
        ("K5", "fused_adaptive_fwd", "fused_adaptive.cu", "pallas_adaptive.py:187",
         fused_adaptive["K5"], ad, bounds),
        ("K6", "fused_adaptive_bwd", "fused_adaptive_bwd.cu", "pallas_adaptive.py:258",
         fused_adaptive["K6"], ad, bounds),
        ("K5", "fused_adaptive_fwd, cluster path (adaptive band, fp32)", "cluster_adaptive.cuh",
         "pallas_adaptive.py:187", band["K5"], band_k, bd_bounds),
        ("K6", "fused_adaptive_bwd, cluster path (adaptive band, fp32)", "cluster_adaptive.cuh",
         "pallas_adaptive.py:258", band["K6"], band_k, bd_bounds),
    ]
    # no single PyTorch call computes a fused stage with its probe VJP, or a
    # whole solve, or their backwards: library_ms is null for every kernel
    kernels = [
        dict(name=name, route="cuda", source=f"continuousnormalizingflows_tpu_torch/csrc/{src}",
             replaces=f"continuousnormalizingflows_tpu/ops/{tpu}", launches=n,
             max_abs_err=res[f"{k.lower()}_max_abs_err"], ms=res[k.lower()],
             plain_ms=res[f"{k.lower()}_plain"], bound_ms=bnd[k][0], bound_by=bnd[k][1],
             library_ms=None)
        for k, name, src, tpu, n, res, bnd in rows
    ]
    write_log()
    (Path("chiprun_out") / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
