#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, on the chip
at the cell's own size.

    python3 port_bench/control.py --workload <name> --seeds 1 2 3 ... [--kinds program tf32 half]

For each seed, in one process: the cell's set-up, a short window (``--seconds``:
enough calls for the check of a scoring cell, a call or more for the window
check of a training cell), then each kind's compared numbers against the
fp32 reference:
``program`` (the port, the lower readings), ``tf32`` (the reference with
every product's operands rounded to TF32 put in the program's place: the
control) and ``half`` (training cells: the reference with half of each
minibatch left out, the mean taken over the rest: a planted fault).  One
JSON line a seed.  A one-chip process; a cell on several chips gives its
control here on one (the reference runs on one card in every run), the
window's checked call taken as the one after set-up's, from the fp32
reference's own state.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["program", "tf32", "half"])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    entry, cell, config, _ = harness.resolve(args.workload)
    harness.set_precision()
    kinds = [k for k in args.kinds if k != "half" or cell["driver"] == "fit"]
    if entry["chips"] > 1 and "program" in kinds:
        kinds.remove("program")  # the program's readings of a multi-chip cell are its runs'
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Ctx(name=args.workload, cell=cell, config=config, seed=seed,
                          seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                          t_start=t0)
        driver = harness.load_module("drivers", cell["driver"]).Driver(ctx)
        if entry["chips"] > 1:
            driver.setup_reference_only()
        else:
            driver.setup()
            harness.run_window(driver, args.seconds)
        driver.free()
        out = {"workload": args.workload, "seed": seed}
        for kind in kinds:
            out[kind] = driver.control_readings(kind)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
