#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (a traced section after the
window).  Both check what the window produced against the plain reference
(``port_bench/reference``) and print each compared number beside its limit
on standard error, then one JSON line on standard output.  Exits non-zero
with no result line where there is no CUDA device or fewer than the cell
needs, where the port cannot be imported, where a run fails, or where JAX or
the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".port_bench_cache"


def cache_env() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cache_env()
    import torch

    # one host thread for tensor work on the host: the run's host side is
    # the dispatch thread, which other threads would only contend with
    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    return harness.main_run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                            torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
