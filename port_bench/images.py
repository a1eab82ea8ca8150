"""Image inputs and conv weights of a run, made on the device from the
streams of :mod:`port_bench.data` (the pool and the weights from the fixed
model seed, the same in every run).  Nothing here imports the program.

The real CIFAR-10 is not in the repository: the pool is 8-bit images of its
shape with image-like structure, a smooth random field over each image (a
coarse Gaussian grid upsampled bilinearly), channels mixed by a shared
luminance, plus fine noise, squashed to 0-255 and rounded.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import data

# images made at once: bounds the floats in flight (a chunk's ~0.1 GB at 32 x 32)
CHUNK = 8192


def synthetic_images(seed: int, n: int, shape: Sequence[int], device) -> torch.Tensor:
    """``(n, c*h*w)`` 8-bit values (``uint8``) with spatial correlation,
    from the ``data`` stream (the model seed's: ``seed`` does not move it)."""
    c, h, w = (int(s) for s in shape)
    g = data.generator(seed, "data", device)
    out = torch.empty((n, c * h * w), dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        coarse = torch.randn((m, c + 1, max(1, h // 4), max(1, w // 4)), generator=g,
                             device=device)
        smooth = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        field = 0.6 * smooth[:, :1] + 0.5 * smooth[:, 1:]
        fine = torch.randn((m, c, h, w), generator=g, device=device)
        x = 255.0 * torch.sigmoid(1.5 * field + 0.25 * fine)
        out[lo: lo + m] = torch.round(x).clamp_(0, 255).to(torch.uint8).reshape(m, -1)
    return out


def conv_weights(seed: int, channels_of: Sequence[Sequence[int]], device) -> List[torch.Tensor]:
    """``nn.Conv2d``'s default draws (weights and biases uniform within ``1 /
    sqrt(9 (in + 1))``) of every block's 3 x 3 convolutions of ``[t, x]``,
    ``[w, b]`` a layer, from one draw of the ``weights`` stream;
    ``channels_of``: each block's widths ``(c, hidden..., c)``."""
    shapes = []
    for chans in channels_of:
        for a, b in zip(chans[:-1], chans[1:]):
            shapes += [((b, a + 1, 3, 3), 9 * (a + 1)), ((b,), 9 * (a + 1))]
    total = sum(math.prod(s) for s, _ in shapes)
    u = torch.rand((total,), generator=data.generator(seed, "weights", device), device=device)
    out, at = [], 0
    for shape, fan_in in shapes:
        k = math.prod(shape)
        out.append(((2.0 * u[at: at + k] - 1.0) / math.sqrt(fan_in)).reshape(shape).contiguous())
        at += k
    return out


def as_chain_params(weights: List[torch.Tensor], layers: int) -> Dict[str, torch.Tensor]:
    """The weights under the port's chain's names, ``blocks.{i}.layers.{j}.weight|bias``."""
    per = 2 * layers
    return {f"blocks.{i // per}.layers.{(i % per) // 2}.{'weight' if i % 2 == 0 else 'bias'}": w
            for i, w in enumerate(weights)}
