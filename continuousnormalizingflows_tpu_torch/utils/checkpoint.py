"""Checkpoint / resume: parameters, optimizer state and step.

Counterpart of ``save_checkpoint`` / ``load_checkpoint`` in
``continuousnormalizingflows_tpu.utils.checkpoint``.  A checkpoint is a
directory holding ``state.pt`` (``torch.save`` of ``{"params",
"opt_state"}``) and ``meta.json`` (the step and whether an optimizer state
is present).  :class:`AsyncCheckpointer` writes the same files from a
worker thread.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointer"]


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


def _host_copy(tree):
    """A CPU copy of every tensor in nested dicts, lists and tuples (other
    leaves as they are).  A CUDA tensor's copy is synchronous: finished when
    this returns."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _writes() -> bool:
    """Only rank 0 writes when ``torch.distributed`` is initialised."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized() and dist.get_rank() != 0)


class AsyncCheckpointer:
    """Checkpoints that do not stall the training loop.

    ``save()`` copies the parameters and the optimizer state to the CPU on
    the caller's thread, and returns once the copy is done: PyTorch's
    optimizers update parameters in place, so a worker that read the live
    tensors would save whatever the next ``opt.step()`` made of them.  A
    single worker thread then writes the files of :func:`save_checkpoint`,
    which :func:`load_checkpoint` and ``ICNFModel.load`` read.

    One save is in flight at a time: a new ``save`` first waits for the
    previous one, so the host holds at most two copies.  ``wait()`` blocks
    until the last save is written (call it before exiting); an error in the
    worker is raised again by the next ``save`` or ``wait``.  With
    ``torch.distributed`` initialised only rank 0 writes.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: str, params: Dict[str, torch.Tensor], opt_state: Any = None,
             step: int = 0) -> None:
        self._join()
        if not _writes():
            return
        host_params = _host_copy(params)
        host_opt = _host_copy(opt_state)

        def work() -> None:
            try:
                save_checkpoint(path, host_params, host_opt, step)
            except Exception as e:  # noqa: BLE001 - raised again by the next save/wait
                self._error = e

        self._thread = threading.Thread(target=work, name="cnf-ckpt", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight (if any) is written."""
        self._join()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
