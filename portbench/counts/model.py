"""Model FLOPs and FAVOR+ launches of one forward at (config, L, N).

The frozen reference is built and run on the meta device: shapes flow,
nothing is computed or allocated. FlopCounterMode counts the matrix
products and convolutions (2 per multiply-add); elementwise work is not
counted, as model FLOPs never count it. A forward pre-hook on each FAVOR+
attention layer records the problems that the serving path's FAVOR+ launch
(kernel C) takes: generalized (ReLU) layers over an attended length of at
least `FUSED_MIN_L`, the rule the port's dispatch follows.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.models.attention import PerformerSelfAttention
from ..reference.models.layers import FUSED_MIN_L
from ..reference.models.rosettafold import RoseTTAFold as Reference

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


@dataclass(frozen=True)
class FavorProblem:
    """One FAVOR+ launch: `rows` independent sequences of length `L`, each
    with `heads` heads of `dh` channels and `m` random features."""

    rows: int
    L: int
    heads: int
    dh: int
    m: int

    def flops(self) -> int:
        # q and k feature maps (L x dh x m each), ctx = k'^T v, num = q' ctx,
        # den = q' . ksum: 2 per multiply-add
        per_head = 2 * self.L * self.m * self.dh * 4 + 2 * self.L * self.m
        return self.rows * self.heads * per_head

    def bytes(self, elem: int = 2) -> int:
        # q, k, v read and the output written once, in the served dtype,
        # and the float32 projection
        return 4 * self.rows * self.L * self.heads * self.dh * elem + 4 * self.m * self.dh

    def bound_s(self, pk: dict, dtype: str = "bfloat16") -> float:
        return max(self.flops() / pk["flops_per_s"][dtype],
                   self.bytes() / pk["hbm_bytes_per_s"])


def count_forward(ref_cfg, L: int, N: int, batch: int = 1) -> Tuple[int, List[FavorProblem]]:
    """(model FLOPs, FAVOR+ launches) of one forward of `batch` chains."""
    with torch.device("meta"):
        model = Reference(ref_cfg, init=False)
    model = model.to("meta").eval()
    problems: List[FavorProblem] = []

    def hook(mod, args, kwargs=None):
        x = args[0]
        attended = x.shape[1] if mod.attend_axis == 1 else x.shape[-2]
        if mod.generalized and attended >= FUSED_MIN_L:
            rows = x.numel() // (attended * x.shape[-1])
            problems.append(FavorProblem(rows, attended, mod.heads, mod.dim_head,
                                         mod.projection.shape[0]))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, PerformerSelfAttention)]
    msa = torch.zeros(batch, N, L, dtype=torch.long, device="meta")
    seq = torch.zeros(batch, L, dtype=torch.long, device="meta")
    aa = torch.arange(L, device="meta").expand(batch, L)
    try:
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(msa, seq, aa)
    finally:
        for h in handles:
            h.remove()
    return int(counter.get_total_flops()), problems


class Counts:
    """count_forward, once per distinct (config, L, N, batch) in a process."""

    def __init__(self):
        self._memo: Dict[tuple, Tuple[int, List[FavorProblem]]] = {}

    def forward(self, ref_cfg, L: int, N: int, batch: int = 1):
        key = (ref_cfg, L, N, batch)
        if key not in self._memo:
            self._memo[key] = count_forward(ref_cfg, L, N, batch)
        return self._memo[key]
