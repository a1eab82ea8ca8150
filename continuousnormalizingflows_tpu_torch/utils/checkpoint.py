"""Checkpoint / resume: parameters, optimizer state and step.

Counterpart of ``save_checkpoint`` / ``load_checkpoint`` in
``continuousnormalizingflows_tpu.utils.checkpoint``.  A checkpoint is a
directory holding ``state.pt`` (``torch.save`` of ``{"params",
"opt_state"}``) and ``meta.json`` (the step and whether an optimizer state
is present).  ``AsyncCheckpointer`` comes with the utils item of ROADMAP.md
Queue 1.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, params: Dict[str, torch.Tensor], opt_state: Any = None,
                    step: int = 0) -> None:
    """Write ``{params, opt_state, step}`` to the directory ``path``.
    ``opt_state``: an optimizer's ``state_dict()`` or None."""
    os.makedirs(path, exist_ok=True)
    payload = {"params": {k: v.detach() for k, v in params.items()}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    torch.save(payload, os.path.join(path, "state.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), "has_opt_state": opt_state is not None}, f)


def load_checkpoint(path: str, map_location=None) -> Tuple[Dict[str, torch.Tensor],
                                                            Optional[Any], int]:
    """Returns ``(params, opt_state, step)``; ``opt_state`` is None when none
    was saved.  Loads tensors only (``weights_only``), onto ``map_location``
    if given."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    payload = torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                         weights_only=True)
    return payload["params"], payload.get("opt_state"), int(meta["step"])
