"""Training loop: fit() over a batch iterator with logging and checkpoints,
resuming from `ckpt_dir/latest` (port of rosettafold_tpu/train/loop.py).

With n_devices > 1 it trains over a ('dp', 'sp', 'tp') mesh
(parallel/mesh.py), one process a GPU in an initialized process group
(train_cli under torchrun): each rank takes its dp block of every batch,
keeps its tp shards of the parameters and their moments, and rank 0 logs and
writes the checkpoints, which hold the whole state.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

from ..parallel import mesh as pmesh
from . import checkpoint as ckpt
from .step import TrainState, create_train_state, make_train_step, to_device


def fit(config, data: Iterator[dict], steps: int, *, seed: int = 0,
        learning_rate: float = 1e-3, ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
        log_every: int = 50, n_devices: Optional[int] = None, sp: int = 1, tp: int = 1,
        accum_steps: int = 1, moment_dtype: str = "float32", log_fn=print,
        device="cuda", mesh: Optional[pmesh.Mesh] = None) -> TrainState:
    """Run `steps` train steps; returns the final TrainState (this rank's
    shards under tp). n_devices > 1 builds the mesh over the process group,
    whose world size it must be; `mesh` passes one built already (e.g.
    `make_mesh(1)`). sp > 1 raises NotImplementedError (ROADMAP queue 1,
    item 6b), n_devices > 1 without an initialized process group
    RuntimeError, and a process group of several ranks without n_devices
    ValueError: fit never trains on one device instead."""
    if sp > 1:
        raise NotImplementedError(pmesh.SP_TODO)
    if mesh is None and (n_devices or 1) > 1:
        mesh = pmesh.make_mesh(n_devices, sp=sp, tp=tp)
    if mesh is None and tp > 1:
        raise ValueError(f"tp={tp} needs a mesh: pass n_devices (the world size)")
    if mesh is None and pmesh.world_size() > 1:
        raise ValueError(f"a process group of {pmesh.world_size()} ranks: pass n_devices="
                         f"{pmesh.world_size()} (train_cli --n-devices), or each rank would"
                         " train alone")
    lead = mesh is None or mesh.rank == 0
    with pmesh.use_mesh(mesh):
        state = create_train_state(config, seed, learning_rate, accum_steps=accum_steps,
                                   moment_dtype=moment_dtype, device=device, mesh=mesh)
        latest = os.path.join(ckpt_dir, "latest") if ckpt_dir else None
        if latest and os.path.exists(os.path.join(latest, "state.pt")):
            state = ckpt.restore(latest, target=state)
            if lead:
                log_fn(f"resumed from step {state.step}")
        step_fn = make_train_step(config)
        t0 = time.perf_counter()
        for i in range(state.step, steps):
            batch = next(data)
            if mesh is not None:
                batch = pmesh.shard_batch(mesh, batch)
            state, metrics = step_fn(state, to_device(batch, device), seed)
            if log_every and (i + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / log_every
                t0 = time.perf_counter()
                if lead:
                    log_fn(f"step {i + 1}/{steps} loss={float(metrics['total']):.4f} "
                           f"drmsd={float(metrics['drmsd']):.3f} "
                           f"grad={float(metrics['grad_norm']):.2f} {dt * 1e3:.0f} ms/step")
            if latest and (i + 1) % ckpt_every == 0:
                ckpt.save(latest, state, async_=True)  # training goes on while it writes
        if latest:
            ckpt.save(latest, state)
    return state
