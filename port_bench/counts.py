"""The yardstick's arithmetic: the card's peaks, the operations and bytes each
kernel's work needs, and the model's operations of a step or a call.

The kernel counts are a frozen copy of ``chip_smoke.py``'s ``stage_fmas``,
``stage_bwd_fmas``, ``param_count``, ``solve_fmas``, ``kernel_bounds`` and
``bound`` (the repository's smoke run), kept here so that a change to the
program cannot move the yardstick.  Every count is of one 3-layer MLP
``n_in -> h -> h -> nz`` (``n_out = nz``), per row, in FMAs (2 FLOP each).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at a 700 W power limit: fp32 outside the
# tensor cores, TF32 and bf16 on them, and the HBM3 rate
PEAKS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def stage_fmas(n_in: int, h: int, nz: int) -> int:
    """FMAs of one stage forward per row: the three layers, then the probe
    VJP u2 = A3^T eps, u1 = A2^T d2, e_z = (A1^T d1)[:nz]."""
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
    once, on their sum over the stages: h adds a stage."""
    fmas = stages * (stage_fmas(n_in, h, nz) - h * nz) + h * nz
    if backward:
        fmas += stages * (stage_bwd_fmas(n_in, h, nz, nz) - 2 * h * nz + h) + 2 * h * nz
    return fmas


def bound(fmas: float, floats: float, peak: float = PEAKS["fp32"]):
    """(bound_s, bound_by): the larger of the operations over ``peak`` and the
    bytes (4 a float, each read or written once) over the memory rate."""
    ops_s, bytes_s = 2 * fmas / peak, 4 * floats / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def kernel_bounds(n_in, h, nz, b, nfe_rows=0, accepted_rows=0, steps=32, peak=PEAKS["fp32"]):
    """Each kernel's (bound_s, bound_by) on one launch's inputs: K3/K4 a
    ``steps``-step rk4 solve of ``b`` rows (4 stage forwards, and for K4 4
    backwards, a step: what the function needs, not its recompute), K5 the
    stage forwards of the trial steps the inputs took (``nfe_rows``: NFE x
    rows summed over the control groups), K6 the six stage forwards and
    backwards of each accepted step (``accepted_rows``).  Floats: the inputs
    read once, the outputs written once, the weights and their gradients."""
    sd, P = nz + 3, param_count(n_in, h, nz)
    return {
        "K3": bound(b * solve_fmas(n_in, h, nz, steps * 4, False), b * (2 * sd + nz) + P, peak),
        "K4": bound(b * solve_fmas(n_in, h, nz, steps * 4, True),
                    b * (3 * sd + 2 * nz) + 2 * P, peak),
        "K5": bound(b * solve_fmas(n_in, h, nz, nfe_rows / b, False), b * (2 * sd + nz) + P,
                    peak),
        "K6": bound(b * solve_fmas(n_in, h, nz, 6 * accepted_rows / b, True),
                    b * (3 * sd + 2 * nz) + 2 * P, peak),
    }


# ---- the model's operations (no recompute) ----

def fit_flops_rk4(n_in: int, h: int, nz: int, b: int, steps: int) -> float:
    """FLOPs of one rk4 train step of ``b`` rows: the forward solve's stage
    evaluations with the probe VJP, and the backward's."""
    return 2.0 * b * solve_fmas(n_in, h, nz, 4 * steps, True)


def fit_flops_adaptive(n_in: int, h: int, nz: int, b: int, nfe_rows: float,
                       accepted_rows: float) -> float:
    """FLOPs of one adaptive train step through the exact discrete backward:
    the forward's stage evaluations (``nfe_rows``) and one stage backward for
    each of the six stages of every accepted step (``accepted_rows``); the
    backward's stage forwards are recompute and not counted."""
    fwd = nfe_rows * (stage_fmas(n_in, h, nz) - h * nz) + b * h * nz
    bwd = 6 * accepted_rows * (stage_bwd_fmas(n_in, h, nz, nz) - 2 * h * nz + h) + 2 * b * h * nz
    return 2.0 * (fwd + bwd)


def exact_eval_flops(n_in: int, h: int, nz: int, b: int) -> float:
    """FLOPs of one evaluation of the dynamics with the analytic exact trace
    on ``b`` rows: the three layers, the trace's extra ``(b, h) x (h, h)``
    product, and its batch-independent ``(h, nz) x (nz, h)`` product."""
    per_row = n_in * h + h * h + h * nz + h * h
    return 2.0 * (b * per_row + h * nz * h)
