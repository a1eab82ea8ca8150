"""Inputs and weights of a run, made on the device.

Each stream has its own generator, seeded from a seed and the stream's
name, so one stream's draws do not depend on another's.  The model's
weights and the rows of its dataset (``MODEL_STREAMS``) are drawn from one
fixed seed, the same in every run; ``--seed`` draws the rest: the order of
the rows (which of them the check steps and each minibatch or call take),
the probes and end times, and the sample of calls a check compares.  So
every seed gives the adaptive solvers the same model and rows, and their
work (the steps they take) changes with the seed only as far as the order
moves it.  Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch

STREAMS = ("weights", "data", "mix", "order", "train", "sample")
MODEL_STREAMS = ("weights", "data", "mix")
MODEL_SEED = 20


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of ``stream``: the run's ``seed`` for the order, the
    probes and the sample, :data:`MODEL_SEED` for the model and its rows."""
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}")
    base = MODEL_SEED if stream in MODEL_STREAMS else seed
    return torch.Generator(device=device).manual_seed(stream_seed(base, stream))


def synthetic_tabular(seed: int, n: int, d: int, device) -> torch.Tensor:
    """``(n, d)`` correlated non-Gaussian rows (the recipe of the JAX
    package's tabular benchmark, written in torch): a random orthogonal mix
    of ``d // 2`` Gaussian columns and ``d - d // 2`` columns of ``tanh(z) +
    0.1 z^2``, in the order that ``seed`` draws."""
    g = generator(seed, "data", device)
    z = torch.randn((n, d), generator=g, device=device)
    gm = generator(seed, "mix", device)
    # the d x d factorization on the host: no solver library to start on the card
    q, r = torch.linalg.qr(torch.randn((d, d), generator=gm, device=device,
                                       dtype=torch.float64).cpu())
    mix = (q * torch.sign(torch.diagonal(r))[None, :]).to(device=device, dtype=torch.float32)
    half = d // 2
    feats = torch.cat([z[:, :half], torch.tanh(z[:, half:]) + 0.1 * z[:, half:] ** 2], dim=1)
    order = torch.randperm(n, generator=generator(seed, "order", device), device=device)
    return (feats @ mix)[order]


def mlp_weights(seed: int, widths, device) -> List[torch.Tensor]:
    """Glorot-uniform weights (``(out, in)``) and zero biases of an MLP,
    ``[w1, b1, w2, b2, ...]``, from one draw on the device."""
    pairs = list(zip(widths[:-1], widths[1:]))
    total = sum(a * b for a, b in pairs)
    u = torch.rand((total,), generator=generator(seed, "weights", device), device=device)
    out, at = [], 0
    for fan_in, fan_out in pairs:
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = (2.0 * u[at: at + fan_in * fan_out] - 1.0) * limit
        at += fan_in * fan_out
        out += [w.reshape(fan_out, fan_in).contiguous(),
                torch.zeros((fan_out,), dtype=torch.float32, device=device)]
    return out


def as_params(weights: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights under the port's ``MLP`` parameter names."""
    return {f"layers.{i // 2}.{'weight' if i % 2 == 0 else 'bias'}": w
            for i, w in enumerate(weights)}
