"""Plain PyTorch reference of the benchmark's model, independent of the program.

The upstream default continuous normalizing flow (ContinuousNormalizingFlows.jl
``src/icnf.jl:53-103``): the state ``u = [z (nz), dlogp, E, n]`` with ``z`` the
data padded by ``naugments`` zeros, the net ``[z, t] -> h -> h -> nz`` with
softplus, ``dz = f(z, t)``, ``dlogp = -tr(df/dz)``, and the RNODE terms
``dE = |f|`` and ``dn = |eps^T df/dz|`` (norms floored at 1e-20 under the
root).  The loss is ``mean(-logpx + l1 E + l2 n + l3 |z_aug(t1)|)`` with
``logpx = log N(z(t1)) - dlogp(t1)``.  Training draws the steered end time
``t1 = 1 + U(-rate, rate)`` and then one Gaussian probe ``eps`` a row.

Three solves, each written out from its description:

* ``rk4_train_terms``: 32 fixed rk4 steps, differentiated by autograd.
* ``dopri5_groups_train_terms``: Dormand-Prince 5(4) with FSAL, each control
  group of ``group`` rows taking its own steps (the RMS error over its rows
  and every state column, the fixed starting step ``0.01 * span``, the
  ``exp``/``log`` step factor); the gradient is the exact discrete one, the
  accept decisions and step sizes held fixed.
* ``dopri5_exact_logpdf``: the same method with one step sequence for the
  whole batch, the Hairer-Norsett-Wanner starting step, the exact trace,
  no gradient.

Weights are ``[w1, b1, w2, b2, w3, b3]`` with each ``w`` of shape ``(out,
in)``.  ``prec`` is ``"fp32"`` (true float32 products: TF32 must be off) or
``"tf32"`` (both operands of every product rounded to TF32's 10 mantissa
bits first, the benchmark's control).  Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)

# Dormand-Prince 5(4): nodes, stage rows, 5th-order weights (= the FSAL row)
# and the error weights (5th minus 4th order, over the 7 stages)
DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
DP_A = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
DP_E = tuple(b - b4 for b, b4 in zip(DP_B + (0.0,), _DP_B4))
DP_ORDER = 5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` on operands rounded to TF32, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ b.t(), a.t() @ g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return _TF32Product.apply(a, b)
    if prec != "fp32":
        raise ValueError(f"prec is 'fp32' or 'tf32', got {prec!r}")
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the fp32 reference needs TF32 off")
    return a @ b


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)


def net_input(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[z, t]``; ``t`` a 0-d tensor or a column of one time a row."""
    t = t.reshape(-1, 1) if t.dim() else t.reshape(1, 1)
    return torch.cat([z, t.to(z.dtype).expand(z.shape[0], 1)], dim=1)


def probe_stage(w: Sequence[torch.Tensor], x: torch.Tensor, eps: torch.Tensor, nz: int,
                prec: str):
    """``(f, eps^T df/dz, div)`` of the net at ``x = [z, t]``."""
    w1, b1, w2, b2, w3, b3 = w
    a1 = mm(x, w1.t(), prec) + b1
    h1 = F.softplus(a1)
    a2 = mm(h1, w2.t(), prec) + b2
    h2 = F.softplus(a2)
    y = mm(h2, w3.t(), prec) + b3
    g2 = mm(eps, w3, prec) * torch.sigmoid(a2)
    g1 = mm(g2, w2, prec) * torch.sigmoid(a1)
    e = mm(g1, w1[:, :nz], prec)
    return y, e, torch.sum(e * eps, dim=-1)


def train_field(w, eps, nz: int, prec: str):
    """The train-mode augmented field ``(t, u) -> du = [f, -div, |f|, |e|]``."""

    def f(t, u):
        y, e, div = probe_stage(w, net_input(u[:, :nz], t), eps, nz, prec)
        return torch.cat([y, -div[:, None], _norm(y)[:, None], _norm(e)[:, None]], dim=1)

    return f


def exact_field(w, nz: int, prec: str):
    """The test-mode field ``(t, u) -> [f, -tr(df/dz), 0, 0]`` by the exact
    trace: ``df/dz = W3 D2 W2 D1 W1[:, :nz]`` with ``D_i`` the softplus
    slopes, so ``tr = sum_{k,l} s1[k] (W2^T o (W1[:, :nz] W3))[k, l] s2[l]``."""
    w1, b1, w2, b2, w3, b3 = w
    g = w2.t() * mm(w1[:, :nz], w3, prec)  # (h, h)

    def f(t, u):
        x = net_input(u[:, :nz], t)
        a1 = mm(x, w1.t(), prec) + b1
        a2 = mm(F.softplus(a1), w2.t(), prec) + b2
        y = mm(F.softplus(a2), w3.t(), prec) + b3
        tr = torch.sum(mm(torch.sigmoid(a1), g, prec) * torch.sigmoid(a2), dim=1)
        zero = torch.zeros_like(tr)[:, None]
        return torch.cat([y, -tr[:, None], zero, zero], dim=1)

    return f


def initial_state(x: torch.Tensor, nz: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((x.shape[0], nz - x.shape[1] + 3))], dim=1)


def base_logpdf(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * (z.shape[1] * LOG_2PI + torch.sum(z * z, dim=1))


def train_terms(u1: torch.Tensor, nvariables: int, nz: int, lambdas) -> torch.Tensor:
    """Per-row ``-logpx + l1 E + l2 n + l3 |z_aug|`` of the terminal state."""
    z = u1[:, :nz]
    logpx = base_logpdf(z) - u1[:, nz]
    aug = torch.sqrt(torch.sum(z[:, nvariables:] ** 2, dim=1))
    l1, l2, l3 = lambdas
    return -logpx + l1 * u1[:, nz + 1] + l2 * u1[:, nz + 2] + l3 * aug


def rk4_train_terms(w, x, eps, t1, nvariables: int, nz: int, lambdas, steps: int,
                    prec: str = "fp32") -> torch.Tensor:
    """Per-row train loss terms of a ``steps``-step rk4 solve over ``[0, t1]``."""
    f = train_field(w, eps, nz, prec)
    t0 = torch.zeros((), dtype=torch.float32, device=x.device)
    dt = (t1 - t0) / steps
    u = initial_state(x, nz)
    for i in range(steps):
        t = t0 + i * dt
        k1 = f(t, u)
        k2 = f(t + 0.5 * dt, u + 0.5 * dt * k1)
        k3 = f(t + 0.5 * dt, u + 0.5 * dt * k2)
        k4 = f(t + dt, u + dt * k3)
        u = u + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return train_terms(u, nvariables, nz, lambdas)


def _dp_trial(f, t, u, dt, k1):
    """One embedded trial from ``k1 = f(t, u)``: ``(u5, err, k7)``; ``t`` and
    ``dt`` a 0-d tensor or a column a row."""
    ks = [k1]
    for i, row in enumerate(DP_A):
        v = u
        for c, k in zip(row, ks):
            v = v + dt * c * k
        ks.append(f(t + DP_C[i + 1] * dt, v))
    u5 = u
    for c, k in zip(DP_B, ks):
        if c != 0.0:
            u5 = u5 + dt * c * k
    k7 = f(t + dt, u5)
    ks.append(k7)
    err = 0.0
    for c, k in zip(DP_E, ks):
        if c != 0.0:
            err = err + dt * c * k
    return u5, err, k7


def dopri5_groups_train_terms(w, x, eps, t1, nvariables: int, nz: int, lambdas, solver: dict,
                              group: int, prec: str = "fp32"):
    """Per-row train loss terms of dopri5 over ``[0, t1]`` with one step
    sequence a control group of ``group`` rows, and each group's ``[nfe,
    naccept, nreject]``.  A group that gives up or runs out of steps is NaN."""
    rtol, atol = solver["rtol"], solver["atol"]
    safety, min_f, max_f = solver["safety"], solver["min_factor"], solver["max_factor"]
    b = x.shape[0]
    n_groups = b // group
    dev = x.device
    f = train_field(w, eps, nz, prec)
    t1 = t1.to(torch.float32)
    span = t1.detach()
    tiny = 1e-12 * torch.clamp(torch.abs(span), min=1.0)

    def per_row(v):
        return v.repeat_interleave(group)[:, None]

    t = torch.zeros(n_groups, dtype=torch.float32, device=dev)
    dt = (span * solver["dt0_fraction"]).expand(n_groups).clone()
    u = initial_state(x, nz)
    k1 = f(per_row(t), u)
    nfe = torch.ones(n_groups, dtype=torch.int64, device=dev)
    steps = torch.zeros_like(nfe)
    nacc = torch.zeros_like(nfe)
    done = torch.zeros(n_groups, dtype=torch.bool, device=dev)
    fail = torch.zeros_like(done)
    while True:
        active = ~(done | fail) & (steps < solver["max_steps"])
        if not bool(active.any()):
            break
        dt_c = torch.minimum(torch.abs(dt), torch.abs(span - t))
        u5, err, k7 = _dp_trial(f, per_row(t), u, per_row(dt_c), k1)
        with torch.no_grad():
            scale = atol + rtol * torch.maximum(torch.abs(u), torch.abs(u5))
            r = err / scale
            ratio = torch.sqrt(torch.sum((r * r).reshape(n_groups, -1), dim=1)
                               / (group * u.shape[1]))
            finite = torch.isfinite(ratio)
            rr = torch.clamp(torch.where(finite, ratio, torch.ones_like(ratio)), min=1e-10)
            factor = torch.clamp(safety * torch.exp(-torch.log(rr) / DP_ORDER), min_f, max_f)
            dt_next = dt_c * torch.where(finite, factor, torch.full_like(factor, min_f))
            accept = finite & (ratio <= 1.0) & active
            t_new = torch.where(accept, t + dt_c, t)
            t_new = torch.where(span - t_new < 0, span, t_new)
            done_new = accept & (torch.abs(span - t_new) <= tiny)
            fail_new = ~finite & (torch.abs(dt_c) <= 1e-6 * torch.abs(span))
        u = torch.where(per_row(accept), u5, u)
        k1 = torch.where(per_row(accept), k7, k1)
        t = torch.where(active, t_new, t)
        dt = torch.where(active, dt_next, dt)
        done = torch.where(active, done_new, done)
        fail = torch.where(active, fail_new, fail)
        nfe = nfe + 6 * active
        steps = steps + active
        nacc = nacc + accept
    u = torch.where(per_row(done), u, torch.full_like(u, float("nan")))
    stats = torch.stack([nfe, nacc, steps - nacc], dim=1)
    return train_terms(u, nvariables, nz, lambdas), stats


def _wrms(v: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> torch.Tensor:
    r = v / (atol + rtol * torch.abs(ref))
    return torch.sqrt(torch.mean(r * r))


def dopri5_exact_logpdf(w, x, nz: int, solver: dict, prec: str = "fp32"):
    """``(logpx (B,), [nfe, naccept, nreject])`` of one test-mode dopri5
    solve over ``[0, 1]``: one RMS error over every element of the batch's
    state, the Hairer-Norsett-Wanner starting step, the ``pow`` step factor,
    the last step landed on ``t1``."""
    rtol, atol = solver["rtol"], solver["atol"]
    safety, min_f, max_f = solver["safety"], solver["min_factor"], solver["max_factor"]
    f = exact_field(w, nz, prec)
    dev = x.device
    t0 = torch.zeros((), dtype=torch.float32, device=dev)
    t1 = torch.ones((), dtype=torch.float32, device=dev)
    span = t1 - t0
    u = initial_state(x, nz)
    k1 = f(t0, u)
    # the Hairer-Norsett-Wanner starting step (one extra evaluation)
    tiny = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    d0, d1 = _wrms(u, u, rtol, atol), _wrms(k1, u, rtol, atol)
    h0 = torch.where(torch.minimum(d0, d1) < 1e-5, tiny, 0.01 * d0 / torch.clamp(d1, min=1e-12))
    h0 = torch.minimum(h0, span)
    f1 = f(t0 + h0, u + h0 * k1)
    d2 = _wrms(f1 - k1, u, rtol, atol) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.maximum(tiny, h0 * 1e-3),
                     torch.pow(torch.clamp(0.01 / torch.clamp(dmax, min=1e-12), min=1e-12),
                               1.0 / (DP_ORDER + 1)))
    dt = torch.minimum(torch.minimum(100.0 * h0, h1), span)
    dt = torch.where(torch.isfinite(dt), dt, solver["dt0_fraction"] * span)
    nfe, steps, nacc = 2, 0, 0
    t, done = t0, False
    while steps < solver["max_steps"]:
        dt_c = torch.minimum(torch.abs(dt), torch.abs(t1 - t))
        u5, err, k7 = _dp_trial(f, t, u, dt_c, k1)
        r = err / (atol + rtol * torch.maximum(torch.abs(u), torch.abs(u5)))
        ratio = torch.sqrt(torch.mean(r * r))
        finite = torch.isfinite(ratio)
        safe = torch.where(finite, torch.clamp(ratio, min=1e-10), torch.ones_like(ratio))
        factor = torch.clamp(safety * torch.pow(safe, -1.0 / DP_ORDER), min_f, max_f)
        factor = torch.where(finite, factor, torch.full_like(factor, min_f))
        accept = finite & (ratio <= 1.0)
        t_new = torch.where(accept, t + dt_c, t)
        t_new = torch.where(t1 - t_new < 0, t1, t_new)
        done_t = accept & (torch.abs(t1 - t_new) <= 1e-12)
        fail_t = ~finite & (torch.abs(dt_c) <= 1e-6)
        stop, acc, done = torch.stack([done_t | fail_t, accept, done_t]).tolist()
        nfe, steps, t, dt = nfe + 6, steps + 1, t_new, dt_c * factor
        if acc:
            nacc += 1
            u, k1 = u5, k7
        if stop:
            break
    if not done:
        u = torch.full_like(u, float("nan"))
    return base_logpdf(u[:, :nz]) - u[:, nz], [nfe, nacc, steps - nacc]


# ---- the optimizer and the draws ----

def adam_step(w: List[torch.Tensor], grads: List[torch.Tensor], state: Optional[dict],
              lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam step with coupled L2 decay (``g + wd * w`` enters the moments):
    ``(new weights, state)``."""
    if state is None:
        state = {"t": 0, "m": [torch.zeros_like(p) for p in w],
                 "v": [torch.zeros_like(p) for p in w]}
    b1, b2 = betas
    t = state["t"] + 1
    out, ms, vs = [], [], []
    for p, g, m, v in zip(w, grads, state["m"], state["v"]):
        g = g + weight_decay * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        denom = torch.sqrt(v) / math.sqrt(1 - b2 ** t) + eps
        out.append(p - (lr / (1 - b1 ** t)) * m / denom)
        ms.append(m)
        vs.append(v)
    return out, {"t": t, "m": ms, "v": vs}


def fit_call_draws(generator_state: torch.Tensor, device, n: int, batch: int, steps: int,
                   nz: int, steer_rate: float):
    """What a ``fit`` call of one epoch over ``n`` rows draws from a generator
    in ``generator_state``: the permutation of the rows, then for each of its
    first ``steps`` steps the steered end time and the probes.  ``(minibatch
    row indices (n // batch, batch), [(t1 (0-d), eps (batch, nz))], the
    generator's state after the draws)``."""
    g = torch.Generator(device=device)
    g.set_state(generator_state)
    perm = torch.randperm(n, generator=g, device=device)
    nb = n // batch
    draws = []
    for _ in range(steps):
        u = torch.rand((), generator=g, dtype=torch.float32, device=device)
        t1 = 1.0 + 1.0 * ((2.0 * u - 1.0) * steer_rate)
        eps = torch.randn((1, batch, nz), generator=g, dtype=torch.float32, device=device)[0]
        draws.append((t1, eps))
    return perm[: nb * batch].reshape(nb, batch), draws, g.get_state()
