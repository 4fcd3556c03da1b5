"""Checkpoints of a TrainState (the port's own format: orbax is JAX).

A checkpoint is a directory holding `state.pt`, the `torch.save` of the
model's state_dict, the optimizer's state_dict and the step. An async save
copies the tensors to the host first and writes on a background thread;
`restore` and the next `save` join it.

Under a mesh (parallel/mesh.py) the file holds the whole state, as orbax's
global arrays do in JAX: `save` gathers each tp-sharded leaf and its Adam
moments on every rank, rank 0 writes, and a sync save ends at a barrier;
`restore` keeps this rank's blocks of the whole leaves. So a checkpoint
resumes at any dp and tp (its directory must be one that every rank reads)
and loads into `predict`'s model as it is.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from ..parallel import mesh as pmesh

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


def _layout(state):
    """{state_dict key: tp dim} of the model's leaves and {optimizer state
    index: tp dim} of their moments (None: replicated)."""
    named = dict(state.model.named_parameters())
    model = {k: pmesh.tp_dim(named[k]) if k in named else None
             for k in state.model.state_dict()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return model, {i: pmesh.tp_dim(p) for i, p in enumerate(params)}


def _apply(fn, state_dicts, layout):
    """fn(tensor, dim) over the model's and the optimizer's leaves."""
    model_sd, opt_sd = state_dicts
    model_dims, opt_dims = layout
    model_sd = {k: fn(v, model_dims.get(k)) for k, v in model_sd.items()}
    opt_sd = dict(opt_sd)
    opt_sd["state"] = {i: {k: fn(v, opt_dims[i]) if isinstance(v, torch.Tensor) and v.dim()
                           else v for k, v in st.items()}
                       for i, st in opt_sd["state"].items()}
    return model_sd, opt_sd


def save(path: str, state, *, async_: bool = False) -> None:
    """Save `state` (train.step.TrainState) into the directory `path`.
    async_=True returns once the tensors are on the host; the file is written
    on a background thread. Under a mesh every rank calls it (the sharded
    leaves are gathered) and rank 0 writes."""
    global _pending
    wait_until_finished()  # saves to one path never overlap
    model_sd, opt_sd = _apply(pmesh.unshard, (state.model.state_dict(),
                                              state.optimizer.state_dict()), _layout(state))
    if pmesh.rank() != 0:
        if not async_:
            pmesh.barrier()
        return
    payload = _to_host({"model": model_sd, "optimizer": opt_sd, "step": state.step})
    path = os.path.abspath(path)
    if not async_:
        _write(path, payload)
        pmesh.barrier()
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
    configuration, under the current mesh: this rank's blocks) and return it."""
    wait_until_finished()
    dev = next(target.model.parameters()).device
    payload = torch.load(os.path.join(os.path.abspath(path), "state.pt"), map_location=dev,
                         weights_only=True)
    model_sd, opt_sd = _apply(pmesh.reshard, (payload["model"], payload["optimizer"]),
                              _layout(target))
    target.model.load_state_dict(model_sd)
    target.optimizer.load_state_dict(opt_sd)
    target.step = int(payload["step"])
    return target
