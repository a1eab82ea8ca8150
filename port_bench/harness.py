"""One run of one cell: set-up, the measured window, the traced section, the
check against the plain reference, and the result line.

Everything particular to a cell is data: ``BENCHMARK.json`` names the cell,
``workloads/<cell>.json`` its traffic (the driver, the solver stack, the
route, the batch, the rows, the spans and the limits of its check),
``configs/<config>.json`` the model, ``drivers/<driver>.py`` the entry point
it drives and ``metrics/<metric>.py`` the reader of each metric.  Adding a
cell, a configuration or a metric adds files and edits none.

A cell on several chips runs one process a card, spawned here; each takes
the same set-up, window and traced section in lockstep, and rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import json
import math
import multiprocessing as mp
import socket
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from . import counts, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the modules that no run may load: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "continuousnormalizingflows_tpu")
JOIN_S = 120


@dataclasses.dataclass
class Ctx:
    """What a run of a cell is given."""

    name: str
    cell: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    rank: int = 0
    world: int = 1
    mesh: Any = None
    t_start: float = 0.0


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, bench: Optional[dict] = None) -> tuple:
    """``(entry, cell, config, metrics)`` of a cell: its BENCHMARK.json entry,
    its workload file, its configuration file, and the end-to-end and
    per-layer metric entries that it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    cell = load_json(HERE / "workloads" / f"{name}.json")
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / cfgs[entry["config"]]["file"])
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json on its "
                         f"config or traffic")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", []) or ("workloads" not in m
                                                       and m["moves"] in reported)]
    return entry, cell, config, {"end_to_end": e2e, "per_layer": per_layer}


# ---- the window ----

def run_window(driver, seconds: float, stop_vote=None) -> dict:
    """Units of the driver, back to back, until ``seconds`` have passed; each
    unit ends in a synchronize.  ``stop_vote(bool) -> bool`` makes ranks
    agree on the last unit.  A driver's ``window_closed()``, where it has
    one, is told when the window ends."""
    units = []
    sync(driver.ctx.device)
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = driver.unit()
        sync(driver.ctx.device)
        end = time.perf_counter()
        units.append(dict(out, seconds=end - t))
        stop = end - start >= seconds
        if stop_vote is not None:
            stop = stop_vote(stop)
        if stop:
            break
    if hasattr(driver, "window_closed"):
        driver.window_closed()
    return dict(seconds=end - start, units=units, steps=sum(u["steps"] for u in units),
                rows=sum(u["rows"] for u in units), bad=sum(u["bad"] for u in units))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _vote(device):
    """Rank 0's decision, sent to every rank."""
    import torch.distributed as dist

    def vote(stop: bool) -> bool:
        flag = torch.tensor([1 if stop else 0], dtype=torch.int32, device=device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    return vote


def _kept(spy) -> list:
    """What a spy kept, on the host: tensors as lists, the rest as it is."""
    out = []
    for v in spy.kept:
        if isinstance(v, torch.Tensor):
            out.append(v.detach().cpu().tolist())
        elif hasattr(v, "_asdict"):
            out.append([int(x) if not isinstance(x, torch.Tensor) or x.dim() == 0 else
                        x.tolist() for x in list(v)[:3]])
        else:
            out.append(v)
    return out


def run_rank(ctx: Ctx) -> Optional[dict]:
    """One process's run: the record that rank 0 turns into the result line
    (``None`` on the other ranks)."""
    driver = load_module("drivers", ctx.cell["driver"]).Driver(ctx)
    driver.setup()
    sync(ctx.device)
    if ctx.world > 1:
        import torch.distributed as dist

        dist.barrier()
    setup_s = time.perf_counter() - ctx.t_start
    vote = _vote(ctx.device) if ctx.world > 1 else None
    rec: Dict[str, Any] = dict(setup_s=setup_s)
    specs = ctx.cell.get("spans", []) if ctx.trace else []
    with trace.spies(specs) as spied:
        for s in spied.values():
            s.reset(ranges=False)
        rec["window"] = run_window(driver, ctx.seconds, vote)
        rec["spans"] = {k: dict(calls=s.calls, kept=_kept(s)) for k, s in spied.items()}
        if ctx.trace:
            for s in spied.values():
                s.reset(ranges=True)
            units = []

            def section():
                for _ in range(int(ctx.cell["trace_units"])):
                    units.append(driver.unit())

            tr = trace.profile(section, host=bool(ctx.cell.get("trace_host", True)))
            tr["steps"] = sum(u["steps"] for u in units)
            tr["rows"] = sum(u["rows"] for u in units)
            tr["spans"] = {k: dict(calls=s.calls, kept=_kept(s)) for k, s in spied.items()}
            rec["trace"] = tr
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    driver.free()
    if ctx.world > 1:
        import torch.distributed as dist

        # each rank's modules are its own: the ones no run may load are looked for in each
        shared = dict({k: rec.get(k) for k in ("memory_peak_bytes", "trace")},
                      forbidden=forbidden_modules())
        gathered = [None] * ctx.world
        dist.all_gather_object(gathered, shared)
        if ctx.rank != 0:
            return None
        rec["ranks"] = gathered
        rec["memory_peak_bytes"] = max(g["memory_peak_bytes"] or 0 for g in gathered)
        rec["forbidden"] = sorted({m for g in gathered for m in g["forbidden"]})
    t = time.perf_counter()
    rec["checks"] = driver.check()
    rec["check_s"] = time.perf_counter() - t
    rec["attempted"], rec["failed"] = driver.attempted(rec["window"])
    return rec


# ---- ranks ----

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_rank(ctx: Ctx, port: int) -> None:
    import torch.distributed as dist

    from continuousnormalizingflows_tpu_torch.parallel import make_mesh

    kw = dict(init_method=f"tcp://localhost:{port}", world_size=ctx.world, rank=ctx.rank,
              timeout=datetime.timedelta(seconds=120))
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.rank)
        ctx.device = torch.device("cuda", ctx.rank)
        dist.init_process_group("nccl", device_id=ctx.device, **kw)
    else:  # the CPU tests' ranks
        dist.init_process_group("gloo", **kw)
    ctx.mesh = make_mesh(device=ctx.device.type)


def rank_main(ctx: Ctx, port: int) -> None:
    """A rank other than 0, in its own process."""
    import torch.distributed as dist

    set_precision()
    torch.set_num_threads(1)
    try:
        _init_rank(ctx, port)
        run_rank(ctx)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_cell(ctx: Ctx) -> dict:
    """Rank 0's run of the cell (spawning the other ranks), as a record."""
    if ctx.world == 1:
        return run_rank(ctx)
    import torch.distributed as dist

    driver = load_module("drivers", ctx.cell["driver"])
    if hasattr(driver, "prepare"):
        driver.prepare(ctx)  # once, before the ranks start
    port = free_port()
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=rank_main, args=(dataclasses.replace(ctx, rank=r), port))
             for r in range(1, ctx.world)]
    for p in procs:
        p.start()
    try:
        _init_rank(ctx, port)
        rec = run_rank(ctx)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.perf_counter() + JOIN_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks 1-{ctx.world - 1} exited with {codes}")
    return rec


# ---- the result ----

def set_precision() -> None:
    """True float32 products everywhere (the configurations state fp32 with
    precision "highest"), asserted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _trace_mean(rec: dict) -> Optional[dict]:
    """The traced section's numbers averaged over the ranks (rank 0's lists),
    with each rank's device seconds of each call of every span
    (``rank_spans``: by span, a list by rank of lists by call)."""
    tr = rec.get("trace")
    if tr is None or "ranks" not in rec:
        return tr
    ranks = [r["trace"] for r in rec["ranks"]]
    out = dict(tr)
    for key in ("window_s", "busy_s"):
        out[key] = statistics.fmean(r[key] for r in ranks)
    out["rank_spans"] = {name: [r["ranges"].get(name, {}).get("each") for r in ranks]
                         for name in tr["ranges"]}
    return out


def result(ctx: Ctx, rec: dict, metrics: dict) -> dict:
    """The result line's object."""
    reader_rec = dict(rec, trace=_trace_mean(rec), ctx=ctx, counts=counts)
    wanted = metrics["per_layer"] if ctx.trace else metrics["end_to_end"]
    values = {}
    for m in wanted:
        v = load_module("metrics", m["name"]).read(reader_rec)
        if v is not None:
            if not math.isfinite(v):
                raise ValueError(f"metric {m['name']} read {v}")
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = rec["checks"]
    ok = checks["ok"] and rec["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks["numbers"].values())
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": ctx.world, "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    out = {"correct": bool(ok), "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": values, "device": device}
    if ctx.trace:
        tr = reader_rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        top = sorted(rec["trace"]["kernels"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": rec["trace"]["gaps"][:10]}
    # a non-finite reading is named, not written as a number JSON lacks
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                         "limit": c["limit"]} for k, c in checks["numbers"].items()}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def print_result(out: dict, extra: dict) -> None:
    """The extra facts and each compared number beside its limit on standard
    error (the compared numbers last), then the result line."""
    for k, v in extra.items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main_run(name: str, seed: int, seconds: float, trace_on: bool, t_start: float,
             device: torch.device) -> int:
    entry, cell, config, metrics = resolve(name)
    set_precision()
    ctx = Ctx(name=name, cell=cell, config=config, seed=seed, seconds=seconds,
              trace=trace_on, device=device, world=int(entry["chips"]), t_start=t_start)
    try:
        rec = run_cell(ctx)
        out = result(ctx, rec, metrics)
    except Exception:
        traceback.print_exc()
        return 1
    found = sorted(set(forbidden_modules()) | set(rec.get("forbidden", [])))
    if found:
        print(f"modules that no run may load are loaded: {found}", file=sys.stderr)
        return 1
    extra = {"card": power_limit() if device.type == "cuda" else "cpu",
             "setup_s": rec["setup_s"], "window_s": rec["window"]["seconds"],
             "check_s": rec["check_s"],
             "units": len(rec["window"]["units"]), "steps": rec["window"]["steps"],
             "unit_seconds": [u["seconds"] for u in rec["window"]["units"]]}
    nfes = [u["nfe_last"] for u in rec["window"]["units"] if u.get("nfe_last") is not None]
    if nfes:
        extra["nfe_of_each_unit_last_step"] = nfes
    extra.update(rec["checks"].get("notes", {}))
    if ctx.trace:
        extra["trace_events"] = rec["trace"]["events"]
        extra["spans"] = rec["trace"]["ranges"]
    print_result(out, extra)
    return 0
