"""Parameters between the JAX package's layout and the port's.

JAX keeps an MLP's parameters as ``[{"w": (in, out), "b": (out,)}, ...]``;
the port keeps the ``nn.Module`` parameter dict
``{"layers.{i}.weight": (out, in), "layers.{i}.bias": (out,)}``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]


def params_from_jax(layers: List[Dict[str, np.ndarray]], device=None,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX list of ``{"w", "b"}`` (numpy or array-likes) -> port parameter dict."""
    params = {}
    for i, layer in enumerate(layers):
        w = np.asarray(layer["w"])
        params[f"layers.{i}.weight"] = torch.tensor(w.T.copy(), dtype=dtype, device=device)
        params[f"layers.{i}.bias"] = torch.tensor(np.asarray(layer["b"]), dtype=dtype,
                                                  device=device)
    return params


def params_to_jax(params: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """Port parameter dict -> JAX list of ``{"w": (in, out), "b": (out,)}`` numpy."""
    n = len(params) // 2
    return [
        {
            "w": params[f"layers.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": params[f"layers.{i}.bias"].detach().cpu().numpy().copy(),
        }
        for i in range(n)
    ]
