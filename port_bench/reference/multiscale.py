"""Plain PyTorch reference of FFJORD's multiscale image flow trained by RNODE's
recipe, independent of the program.

Written from the papers and FFJORD's code as they describe it: Grathwohl et
al., ICLR 2019 (arXiv:1810.01367; ``lib/odenvp.py``, ``ODEnet`` of
``ConcatConv2d`` layers) and Finlay et al., ICML 2020 (arXiv:2002.02798,
github.com/cfinlay/ffjord-rnode: kinetic and Jacobian regularisation,
fixed-step rk4).

* The field of a block on ``(c, h, w)``: 3 x 3 convolutions (stride 1,
  padding 1, with bias) of ``[t, x]`` (a constant channel ``t`` in front),
  ``c + 1 -> 64``, ``65 -> 64``, ``65 -> 64``, ``65 -> c``, softplus between.
* The block's ODE over ``[0, 1]``: ``dz = f(z, t)``, ``dlogp = -eps^T
  (df/dz) eps`` (one Rademacher ``eps`` a row, held over the solve), ``dE =
  |f|``, ``dn = |eps^T df/dz|`` (norms floored at 1e-20 under the root).
* The chain: ``s = alpha + (1 - 2 alpha) x``, ``y = logit(s)`` with
  ``sum log((1 - 2 alpha) / (s (1 - s)))`` added to ``log p``; then, scale
  after scale (one a halving of the sides while both are at least 4), two
  blocks, and on every scale but the last a squeeze (each 2 x 2 patch to
  channels), two blocks and the upper half of the channels to N(0, I); the
  last scale's state all to N(0, I).
* The loss: ``mean(-log p(x) + l1 sum_b E_b + l2 sum_b n_b)``.
* The solve: rk4 over ``steps`` equal steps.  The gradient: the backsolve
  adjoint written out (:class:`Block`): reverse rk4 over the state ``[z,
  dlogp, E, n]``, its adjoint ``a`` and the weights' ``a_theta`` on the same
  grid from ``t = 1`` to ``0``, each stage's ``(f, -a^T df/du, -a^T
  df/dtheta)`` by ``torch.autograd.grad``; the rest of the chain by autograd.

Departures from the papers: the end time is fixed at 1 (FFJORD's
``--train_T`` learns it); the regularisers are the norms, not RNODE's
squared norms; the batch is the benchmark's.  ``prec`` is ``"fp32"`` (TF32
off) or ``"tf32"``: both operands of every convolution rounded to TF32's 10
mantissa bits first (the benchmark's control; the rounding is outside the
gradient).  Weights: ``[w, b]`` a layer, 4 layers a block, blocks in chain
order.  Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        if x.is_cuda and torch.backends.cudnn.allow_tf32:
            raise RuntimeError("the fp32 reference needs TF32 off")
        return x
    if prec != "tf32":
        raise ValueError(f"prec is 'fp32' or 'tf32', got {prec!r}")
    return x + (to_tf32(x.detach()) - x.detach())


# ---- the layout ----

def scales(shape: Sequence[int]) -> int:
    _c, h, w = shape
    n = 0
    while h >= 4 and w >= 4:
        n, h, w = n + 1, h // 2, w // 2
    return n


def layout(shape: Sequence[int], nblocks: int = 2, n_scale: int = 0) -> List[tuple]:
    """The chain's steps: ``("block", (c, h, w))``, ``("squeeze", None)``,
    ``("factor", c_kept)``; ``n_scale`` 0: as many scales as the shape has."""
    c, h, w = shape
    k_all = scales(shape) if n_scale <= 0 else min(n_scale, scales(shape))
    out: List[tuple] = []
    for k in range(k_all):
        out += [("block", (c, h, w))] * nblocks
        if k < k_all - 1:
            c, h, w = 4 * c, h // 2, w // 2
            out += [("squeeze", None)] + [("block", (c, h, w))] * nblocks
            c //= 2
            out.append(("factor", c))
    return out


def block_shapes(shape, nblocks: int = 2, n_scale: int = 0) -> List[Tuple[int, int, int]]:
    return [s for kind, s in layout(shape, nblocks, n_scale) if kind == "block"]


def squeeze(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)


def unsqueeze(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c // 4, 2, 2, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, c // 4, h * 2, w * 2)


# ---- one block ----

def field(ws: Sequence[torch.Tensor], z: torch.Tensor, t: torch.Tensor, shape,
          prec: str) -> torch.Tensor:
    """``f(z, t)`` of rows ``z`` ``(B, c*h*w)``."""
    c, h, w = shape
    x = z.reshape(-1, c, h, w)
    plane = t.reshape(1, 1, 1, 1).expand(x.shape[0], 1, h, w)
    n = len(ws) // 2
    for i in range(n):
        x = F.conv2d(_operand(torch.cat([plane, x], dim=1), prec), _operand(ws[2 * i], prec),
                     ws[2 * i + 1], stride=1, padding=1)
        if i < n - 1:
            x = F.softplus(x)
    return x.reshape(z.shape[0], -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=1) + 1e-20)


def aug_field(ws, u: torch.Tensor, t: torch.Tensor, eps: torch.Tensor, shape, reg: bool,
              prec: str, graph: bool) -> torch.Tensor:
    """``du = [f, -eps^T J eps, |f|, |eps^T J|]`` of the state ``u = [z,
    dlogp, E, n]`` (the regularisers 0 without ``reg``); ``graph``: keep
    the graph of ``eps^T J`` (a VJP of ``du`` follows)."""
    d = eps.shape[1]
    with torch.enable_grad():
        z = u[:, :d]
        if not z.requires_grad:
            z = z.detach().requires_grad_()
        f = field(ws, z, t, shape, prec)
        ej = torch.autograd.grad(f, z, eps, create_graph=graph)[0]
    div = torch.sum(ej * eps, dim=1)
    zero = torch.zeros_like(div)
    regs = [_norm(f), _norm(ej)] if reg else [zero, zero]
    return torch.cat([f, -div[:, None], regs[0][:, None], regs[1][:, None]], dim=1)


def rk4(fn, y: list, t0: float, t1: float, steps: int) -> list:
    """``steps`` rk4 steps of ``fn(t, y) -> dy`` (lists of tensors) from
    ``t0`` to ``t1``; ``t`` a 0-d tensor."""
    dev = y[0].device
    dt = (t1 - t0) / steps
    for i in range(steps):
        t = torch.tensor(t0 + i * dt, dtype=torch.float32, device=dev)
        k1 = fn(t, y)
        k2 = fn(t + 0.5 * dt, [a + 0.5 * dt * b for a, b in zip(y, k1)])
        k3 = fn(t + 0.5 * dt, [a + 0.5 * dt * b for a, b in zip(y, k2)])
        k4 = fn(t + dt, [a + dt * b for a, b in zip(y, k3)])
        y = [a + dt / 6.0 * (p + 2.0 * q + 2.0 * r + s)
             for a, p, q, r, s in zip(y, k1, k2, k3, k4)]
    return y


class Block(torch.autograd.Function):
    """One block's solve ``u0 -> u1`` over ``[0, 1]``; its backward the
    backsolve adjoint, written out."""

    @staticmethod
    def forward(ctx, u0, eps, static, *ws):
        shape, reg, steps, prec = static
        with torch.no_grad():
            u1 = rk4(lambda t, y: [aug_field(ws, y[0], t, eps, shape, reg, prec, False)],
                     [u0], 0.0, 1.0, steps)[0]
        ctx.static = static
        ctx.save_for_backward(u1, eps, *ws)
        return u1

    @staticmethod
    def backward(ctx, g):
        shape, reg, steps, prec = ctx.static
        u1, eps, *ws = ctx.saved_tensors

        def adjoint(t, y):
            u, a = y[0], y[1]
            with torch.enable_grad():
                uu = u.detach().requires_grad_()
                wv = [w.detach().requires_grad_() for w in ws]
                du = aug_field(wv, uu, t, eps, shape, reg, prec, True)
                vjp = torch.autograd.grad(du, [uu] + wv, a)
            return [du.detach()] + [-v for v in vjp]

        y1 = [u1, g] + [torch.zeros_like(w) for w in ws]
        y0 = rk4(adjoint, y1, 1.0, 0.0, steps)
        return (y0[1], None, None, *y0[2:])


# ---- the chain ----

def _normal(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * (z.shape[1] * LOG_2PI + torch.sum(z * z, dim=1))


def chain(ws: Sequence[torch.Tensor], x: torch.Tensor, probes: Sequence[torch.Tensor],
          shape, nblocks: int, alpha: float, reg: bool, steps: int, prec: str = "fp32",
          n_scale: int = 0):
    """``(log p(x), sum_b E_b, sum_b n_b, latents)`` of dequantised rows
    ``x`` ``(B, c*h*w)`` in ``[0, 1]``; ``probes``: one ``(B, d_b)``
    Rademacher draw a block; ``ws``: 8 tensors a block."""
    b = x.shape[0]
    s = alpha + (1.0 - 2.0 * alpha) * x
    y = torch.log(s) - torch.log(1.0 - s)
    logp = torch.sum(math.log(1.0 - 2.0 * alpha) - torch.log(s * (1.0 - s)), dim=1)
    e_sum = torch.zeros_like(logp)
    n_sum = torch.zeros_like(logp)
    state = y.reshape((b,) + tuple(shape))
    latents = []
    i = 0
    for kind, arg in layout(shape, nblocks, n_scale):
        if kind == "block":
            z = state.reshape(b, -1)
            u0 = torch.cat([z, z.new_zeros((b, 3))], dim=1)
            u1 = Block.apply(u0, probes[i], (arg, reg, steps, prec), *ws[8 * i: 8 * i + 8])
            d = z.shape[1]
            state = u1[:, :d].reshape((b,) + arg)
            logp = logp - u1[:, d]
            e_sum = e_sum + u1[:, d + 1]
            n_sum = n_sum + u1[:, d + 2]
            i += 1
        elif kind == "squeeze":
            state = squeeze(state)
        else:
            gone = state[:, arg:].reshape(b, -1)
            latents.append(gone)
            logp = logp + _normal(gone)
            state = state[:, :arg]
    last = state.reshape(b, -1)
    latents.append(last)
    logp = logp + _normal(last)
    return logp, e_sum, n_sum, torch.cat(latents, dim=1)


def train_terms(ws, x, probes, shape, nblocks: int, alpha: float, lambdas, steps: int,
                prec: str = "fp32", n_scale: int = 0) -> torch.Tensor:
    """Per-row ``-log p(x) + l1 sum E + l2 sum n``."""
    logp, e, n, _z = chain(ws, x, probes, shape, nblocks, alpha, True, steps, prec, n_scale)
    return -logp + lambdas[0] * e + lambdas[1] * n


# ---- the draws ----

def fit_call_draws(generator_state: torch.Tensor, device, n: int, batch: int, steps: int,
                   dims: Sequence[int]):
    """What a ``fit`` call of one epoch over ``n`` rows draws from a generator
    in ``generator_state``, with the dequantising batch transform: the
    permutation of the rows, then for each of its first ``steps`` steps the
    noise ``u ~ U[0, 1)`` of the minibatch and one Rademacher probe a block
    (``dims``: each block's width), in block order.  ``(minibatch row
    indices (n // batch, batch), [(u (batch, D), [eps_b (batch, d_b)])], the
    generator's state after the draws)``."""
    g = torch.Generator(device=device)
    g.set_state(generator_state)
    perm = torch.randperm(n, generator=g, device=device)
    nb = n // batch
    draws = []
    for _ in range(steps):
        u = torch.rand((batch, dims[0]), generator=g, dtype=torch.float32, device=device)
        eps = [2.0 * torch.randint(0, 2, (1, batch, d), generator=g, device=device)[0]
               .to(torch.float32) - 1.0 for d in dims]
        draws.append((u, eps))
    return perm[: nb * batch].reshape(nb, batch), draws, g.get_state()
