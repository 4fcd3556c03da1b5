"""Sinusoidal positional-encoding tables (port of rosettafold_tpu/ops/sinusoidal.py)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_table(max_len: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(max_len, dim) table; even columns sin(pos/denom), odd columns cos(pos/denom)."""
    denom = np.exp(np.log(10000.0) * np.arange(0, dim, 2, dtype=np.float64) / dim)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    table = np.zeros((max_len, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos / denom)
    table[:, 1::2] = np.cos(pos / denom[: table[:, 1::2].shape[1]])
    return torch.as_tensor(table, dtype=dtype, device=device)


def gather_pe(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of the PE table: idx (..., L) int -> (..., L, dim)."""
    return table[idx.long()]
