"""End-to-end usage of the port, the counterpart of ``examples/usage.py``
(the reference's ``examples/usage.jl``).

    python -m continuousnormalizingflows_tpu_torch.usage --out DIR [--epochs N] [--device cpu]

Fits the reference's example task (1-D Beta(2,4), n = 1,024, the default
augmented RNODE with STEER, rk4-32 with backprop) with the reference's
default optimizer, saves and loads the fitted params, evaluates the density
against the truth, draws samples (with and without the trace, and with
their log-densities in one solve), reads the flow's trajectories, refits
with a logistic base, and serves the exported log-density against
``log_prob``.  Runs on the card unless given ``--device cpu``; writes only
under ``--out`` (the checkpoint, the artifact, the figures where matplotlib
is present, and ``usage.json`` with the numbers printed and each part's
host seconds).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

import continuousnormalizingflows_tpu_torch as cnf
from continuousnormalizingflows_tpu_torch import distributions as dists
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig, TraceEstimator
from continuousnormalizingflows_tpu_torch.config import resolve_device
from continuousnormalizingflows_tpu_torch.utils import datasets
from continuousnormalizingflows_tpu_torch.utils import export as cnf_export
from continuousnormalizingflows_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

NDATA = 1024
# the served log-density against the eager one (the example's check)
SERVED_ATOL = 1e-5


def _plot(out, icnf, params, d, r, log):
    """The density against the truth, and the flow's paths over time, where
    matplotlib is present."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log("matplotlib not available; skipping the plots")
        return
    grid = torch.linspace(0.0, 1.0, 256, device=r.device)
    fig, ax = plt.subplots()
    ax.set_title("Result")
    ax.plot(grid.cpu(), datasets.beta_pdf(grid).cpu(), label="Actual")
    ax.plot(grid.cpu(), d.pdf(grid[:, None]).cpu(), label="Estimated")
    ax.legend()
    fig.savefig(os.path.join(out, "result-figure.png"), dpi=120)
    ts = torch.linspace(0.0, 1.0, 33)
    path, _stats = cnf.trajectory(icnf, r[::8], params, ts)  # (T, b, nz)
    fig2, ax2 = plt.subplots()
    ax2.set_title("Flow trajectories z(t)")
    ax2.set_xlabel("t")
    for i in range(path.shape[1]):
        ax2.plot(ts, path[:, i, 0].cpu(), lw=0.8)
    fig2.savefig(os.path.join(out, "trajectories.png"), dpi=120)
    plt.close("all")
    log("wrote result-figure.png and trajectories.png")


def run(out: str, epochs: int = 300, device=None, log=print) -> dict:
    """The example, end to end, writing under ``out``; returns its numbers."""
    device = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    res = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(part):  # the host seconds of each part of the example
        now = time.perf_counter()
        res["seconds"][part] = now - clock[0]
        clock[0] = now

    # ---- data and model (usage.jl's "Data" and "Model" blocks) ----
    r = datasets.beta_samples(torch.Generator(device=device).manual_seed(0), NDATA)
    icnf = cnf.ICNF.create(
        nvariables=r.shape[1], naugments=r.shape[1] + 1, nconditions=0,
        lambda_1=0.01, lambda_2=0.01, lambda_3=0.01, steer_rate=0.1, tspan=(0.0, 1.0),
        autonomous=False, trace=TraceEstimator.HUTCH_VJP,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32))

    # ---- fit, save, load ----
    model = cnf.ICNFModel(icnf, batchsize=NDATA, epochs=epochs, log_every=64, device=device,
                          generator=torch.Generator(device=device).manual_seed(1),
                          callback=lambda it, l: log(f"Iteration: {it} | Loss: {l:.4f}"))
    fit = model.fit(r)
    ckpt = os.path.join(out, "icnf-machine")
    save_checkpoint(ckpt, fit.params, step=fit.stats["iterations"])
    params, _opt, step = load_checkpoint(ckpt, map_location=device)
    res.update(final_loss=float(fit.stats["final_loss"]), iterations=step)
    lap("fit, save, load")
    log(f"fit: {step} steps, final loss {res['final_loss']:.4f}")

    # ---- use it ----
    d = cnf.ICNFDist(icnf, params, mode=Mode.TEST)
    actual = datasets.beta_pdf(r[:, 0])
    estimated = d.pdf(r)
    new_data = d.sample(NDATA, torch.Generator(device=device).manual_seed(2))
    fast_data = d.sample(NDATA, torch.Generator(device=device).manual_seed(2), trace_free=True)
    pairs, pair_logp = d.sample_with_logpdf(8, torch.Generator(device=device).manual_seed(3))
    path, traj_stats = cnf.trajectory(icnf, r[::8], params, torch.linspace(0.0, 1.0, 33))
    for name, t in (("pdf", estimated), ("sample", new_data), ("trace-free sample", fast_data),
                    ("sample_with_logpdf", pair_logp), ("trajectory", path)):
        if not bool(torch.all(torch.isfinite(t))):
            raise RuntimeError(f"usage: the {name} values are not finite")

    # ---- evaluate it ----
    err = (estimated - actual).abs()
    res.update(mad=float(err.mean()), msd=float((err * err).mean()),
               tv=float(err.sum() / NDATA), sample_mean=float(new_data.mean()),
               trace_free_mean=float(fast_data.mean()), trajectory_nfe=int(traj_stats.nfe),
               pairs=list(pairs.shape))
    log(f"mad={res['mad']:.4f}  msd={res['msd']:.4f}  tv={res['tv']:.4f}")
    log("note: with augmentation (naugments > 0, the reference default) the density is the "
        "zero-padded joint slice and is not normalized over x; set naugments=0 for calibrated "
        "densities")
    log(f"sample mean={res['sample_mean']:.4f} (Beta(2,4) mean={1 / 3:.4f})")
    lap("density, samples, trajectory")
    _plot(out, icnf, params, d, r, log)
    lap("plots")

    # ---- a custom base: the refit with a logistic base ----
    icnf_log = cnf.ICNF.create(nvariables=1, naugments=0, lambda_3=0.0,
                               base_dist=dists.logistic(), solver=icnf.config.solver)
    res_log = cnf.ICNFModel(icnf_log, batchsize=0, epochs=max(1, epochs // 5), device=device,
                            generator=torch.Generator(device=device).manual_seed(5)).fit(r)
    res["logistic_final_loss"] = float(res_log.stats["final_loss"])
    lap("logistic-base fit")
    log(f"logistic-base final loss: {res['logistic_final_loss']:.4f}")

    # ---- serving: the fitted flow's log-density as a saved artifact ----
    artifact_path = os.path.join(out, "model.pt2")
    cnf_export.save_artifact(artifact_path, cnf_export.export_logpdf(icnf, params, device=device))
    served = cnf_export.load_artifact(artifact_path).call(r)
    with torch.no_grad():
        eager = cnf.log_prob(icnf, Mode.TEST, r, params)
    res["served_max_abs_diff"] = float((served - eager).abs().max())
    res["served_matches"] = bool(torch.allclose(served, eager, atol=SERVED_ATOL))
    lap("export, save, load, serve")
    log(f"served logp matches: {res['served_matches']} (max abs diff "
        f"{res['served_max_abs_diff']:.3e})")
    log("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items()))
    with open(os.path.join(out, "usage.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the directory every output is written to")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--device", default=None, help='"cpu", or the card by default')
    args = ap.parse_args(argv)
    res = run(args.out, args.epochs, args.device)
    return 0 if res["served_matches"] else 1


if __name__ == "__main__":
    sys.exit(main())
