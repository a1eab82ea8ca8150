"""The model's operations of FFJORD's multiscale flow (the chain of conv
blocks): a frozen count, beside :mod:`port_bench.counts`, so that a change to
the program cannot move the yardstick.  FLOPs are 2 a multiply-add; only the
convolutions count (the elementwise work, the probes' products and the
solver's sums do not).

Per row and block on ``(c, h, w)``, each conv layer ``in -> out`` (3 x 3,
an input of ``[t, x]``, ``in + 1`` channels) takes ``U1 = 2 * 9 * (in + 1)
* out * h * w`` forward and ``U = 2 * 9 * in * out * h * w`` for each
product with its weight that leaves the ``t`` channel out:

* the field ``f``: ``sum U1``; its probe VJP ``eps^T df/dz``: ``sum U``;
* a forward stage (the field and its probe VJP): ``sum (U1 + U)``;
* a stage of the adjoint's backward solve: the stage again, and its VJP
  with respect to the state and the weights: the field's data and weight
  gradients (``U + U1``), the probe VJP's (``2 U``): ``sum (2 U1 + 4 U)``.

A train step of the backsolve adjoint over ``stages`` rk4 stages a solve:
``stages`` forward stages and ``stages`` backward stages a block.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def block_shapes(shape: Sequence[int], nblocks: int) -> List[Tuple[int, int, int]]:
    """Each block's ``(c, h, w)`` in FFJORD's ``ODENVP`` layout: per scale
    (one a halving while both sides are at least 4) ``nblocks`` on ``(c, h,
    w)``, then, but on the last, ``nblocks`` on ``(4c, h/2, w/2)`` and half
    the channels factored out."""
    c, h, w = shape
    k_all, hh, ww = 0, h, w
    while hh >= 4 and ww >= 4:
        k_all, hh, ww = k_all + 1, hh // 2, ww // 2
    out: List[Tuple[int, int, int]] = []
    for k in range(k_all):
        out += [(c, h, w)] * nblocks
        if k < k_all - 1:
            c, h, w = 4 * c, h // 2, w // 2
            out += [(c, h, w)] * nblocks
            c //= 2
    return out


def _units(shape, hidden: Sequence[int]) -> Tuple[float, float]:
    """``(sum U1, sum U)`` of one block's layers, per row."""
    c, h, w = shape
    chans = [c] + list(hidden) + [c]
    u1 = sum(2.0 * 9 * (a + 1) * b * h * w for a, b in zip(chans[:-1], chans[1:]))
    u = sum(2.0 * 9 * a * b * h * w for a, b in zip(chans[:-1], chans[1:]))
    return u1, u


def field_flops(shape, nblocks: int, hidden: Sequence[int], b: int) -> float:
    """FLOPs of one evaluation of every block's field on ``b`` rows."""
    return b * sum(_units(s, hidden)[0] for s in block_shapes(shape, nblocks))


def fit_flops_adjoint(shape, nblocks: int, hidden: Sequence[int], b: int, stages: int) -> float:
    """FLOPs of one train step of ``b`` rows through the backsolve adjoint,
    ``stages`` stages a solve (rk4: 4 a step), no recompute counted."""
    total = 0.0
    for s in block_shapes(shape, nblocks):
        u1, u = _units(s, hidden)
        total += stages * (u1 + u) + stages * (2 * u1 + 4 * u)
    return b * total
