"""Checkpoints of a TrainState (the port's own format: orbax is JAX).

A checkpoint is a directory holding `state.pt`, the `torch.save` of the
model's state_dict, the optimizer's state_dict and the step. An async save
copies the tensors to the host first and writes on a background thread;
`restore` and the next `save` join it.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

_pending: Optional[threading.Thread] = None
_error: Optional[BaseException] = None


def wait_until_finished() -> None:
    """Block until the in-flight async save, if any, is on disk; re-raise
    its error."""
    global _pending, _error
    if _pending is not None:
        _pending.join()
        _pending = None
    if _error is not None:
        err, _error = _error, None
        raise err


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, payload) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"state.pt.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))  # a reader never sees half a file


def save(path: str, state, *, async_: bool = False) -> None:
    """Save `state` (train.step.TrainState) into the directory `path`.
    async_=True returns once the tensors are on the host; the file is written
    on a background thread."""
    global _pending
    wait_until_finished()  # saves to one path never overlap
    payload = _to_host({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(), "step": state.step})
    path = os.path.abspath(path)
    if not async_:
        _write(path, payload)
        return

    def run():
        global _error
        try:
            _write(path, payload)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait_until_finished
            _error = e

    _pending = threading.Thread(target=run, daemon=True)
    _pending.start()


def restore(path: str, target):
    """Load the checkpoint in `path` into `target` (a TrainState of the same
    configuration) and return it."""
    wait_until_finished()
    dev = next(target.model.parameters()).device
    payload = torch.load(os.path.join(os.path.abspath(path), "state.pt"), map_location=dev,
                         weights_only=True)
    target.model.load_state_dict(payload["model"])
    target.optimizer.load_state_dict(payload["optimizer"])
    target.step = int(payload["step"])
    return target
