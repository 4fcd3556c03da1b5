"""Training loop: fit() over a batch iterator with logging and checkpoints,
resuming from `ckpt_dir/latest` (port of rosettafold_tpu/train/loop.py,
one device)."""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

from . import checkpoint as ckpt
from .step import TrainState, create_train_state, make_train_step, to_device


def fit(config, data: Iterator[dict], steps: int, *, seed: int = 0,
        learning_rate: float = 1e-3, ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
        log_every: int = 50, n_devices: Optional[int] = None, sp: int = 1, tp: int = 1,
        accum_steps: int = 1, moment_dtype: str = "float32", log_fn=print,
        device="cuda") -> TrainState:
    """Run `steps` train steps on one device; returns the final TrainState.
    The mesh arguments (n_devices, sp, tp) belong to the multi-GPU slice of
    the port: any of them above 1 raises NotImplementedError."""
    if (n_devices or 1) > 1 or sp > 1 or tp > 1:
        raise NotImplementedError("training on a mesh (n_devices, sp, tp > 1) is not ported")
    state = create_train_state(config, seed, learning_rate, accum_steps=accum_steps,
                               moment_dtype=moment_dtype, device=device)
    latest = os.path.join(ckpt_dir, "latest") if ckpt_dir else None
    if latest and os.path.exists(os.path.join(latest, "state.pt")):
        state = ckpt.restore(latest, target=state)
        log_fn(f"resumed from step {state.step}")
    step_fn = make_train_step(config)
    t0 = time.perf_counter()
    for i in range(state.step, steps):
        state, metrics = step_fn(state, to_device(next(data), device), seed)
        if log_every and (i + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / log_every
            t0 = time.perf_counter()
            log_fn(f"step {i + 1}/{steps} loss={float(metrics['total']):.4f} "
                   f"drmsd={float(metrics['drmsd']):.3f} "
                   f"grad={float(metrics['grad_norm']):.2f} {dt * 1e3:.0f} ms/step")
        if latest and (i + 1) % ckpt_every == 0:
            ckpt.save(latest, state, async_=True)  # training goes on while it writes
    if latest:
        ckpt.save(latest, state)
    return state
