"""Parameters between the JAX package's layout and the port's.

JAX keeps an MLP's parameters as ``[{"w": (in, out), "b": (out,)}, ...]``;
the port keeps the ``nn.Module`` parameter dict
``{"layers.{i}.weight": (out, in), "layers.{i}.bias": (out,)}``.  A planar
net's ``{"u", "w", "b"}`` has the same layout in both.  An MLP of any depth
converts layer by layer, both ways; a ``CondLayer``'s params are its inner
net's, and convert as they do (held for a 4-hidden-layer MLP and a
``CondLayer`` around one, bit for bit both ways).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]

_PLANAR_KEYS = ("u", "w", "b")


def params_from_jax(layers: Union[List[Dict[str, np.ndarray]], Dict[str, np.ndarray]],
                    device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX params (numpy or array-likes) -> port parameter dict: an MLP's
    list of ``{"w", "b"}``, or a planar net's ``{"u", "w"[, "b"]}``."""
    if isinstance(layers, dict):
        return {k: torch.tensor(np.asarray(layers[k]), dtype=dtype, device=device)
                for k in _PLANAR_KEYS if k in layers}
    params = {}
    for i, layer in enumerate(layers):
        w = np.asarray(layer["w"])
        params[f"layers.{i}.weight"] = torch.tensor(w.T.copy(), dtype=dtype, device=device)
        params[f"layers.{i}.bias"] = torch.tensor(np.asarray(layer["b"]), dtype=dtype,
                                                  device=device)
    return params


def params_to_jax(params: Dict[str, torch.Tensor]):
    """Port parameter dict -> JAX params as numpy: an MLP's list of ``{"w":
    (in, out), "b": (out,)}``, or a planar net's ``{"u", "w"[, "b"]}``."""
    if "u" in params:
        return {k: params[k].detach().cpu().numpy().copy() for k in _PLANAR_KEYS if k in params}
    n = len(params) // 2
    return [
        {
            "w": params[f"layers.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": params[f"layers.{i}.bias"].detach().cpu().numpy().copy(),
        }
        for i in range(n)
    ]
