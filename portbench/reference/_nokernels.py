"""Stand-in for the port's kernel modules: the reference runs the plain path
only (attn_impl="xla"), so any kernel entry it reaches is a fault.
`gather_src` is the one plain helper the bucketed SE(3) layout takes from
the kernel module; it is copied here."""

from __future__ import annotations

import torch


def gather_src(h, src_idx, mask=None):
    """Node features (B, L, m, n) at each slot's source: (B, J, S, m, n).
    Masked slots (where `mask` is False) read node 0, whatever their index."""
    if mask is not None:
        src_idx = torch.where(mask, src_idx, torch.zeros_like(src_idx))
    B, J, S = src_idx.shape
    rows = torch.gather(h.reshape(B, h.shape[1], -1), 1,
                        src_idx.long().reshape(B, J * S, 1).expand(-1, -1, h[0, 0].numel()))
    return rows.reshape(B, J, S, *h.shape[2:])


def __getattr__(name):
    def kernel(*_args, **_kwargs):
        raise RuntimeError(f"the plain reference reached kernel entry {name!r}")
    return kernel
