"""The states between the stages of a forward, kept as the forward runs, so
that the check can follow the program stage by stage.

A RoseTTAFold forward (the port's or the reference's: the module names
are the same) runs the embeddings, then its stages in order (`stage_names`):
two_track_i, initial_coords, then each three-track block's two-track part,
SE(3) coordinate update and feedback, the final block's, then the
prediction head (`head_points`): its projection, and in each of its four
ResNets the input, the stem's output (block_0's input), every residual
block's output and the logits. `Capture` hooks each of these and keeps a
copy of the tensors, on their device or on the host (`store`): the copy is
taken in stream order, before the next stage runs, so a later in-place
update cannot reach it. It runs on a request served after the window, so
its copies cost the timed requests nothing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils._pytree import tree_map

HEADS = ("theta", "phi", "dist", "omega")


def stage_names(cfg) -> List[str]:
    """The trunk's stages in forward order; a three-track block is three: its
    two-track part, its SE(3) coordinate update and its structure-to-MSA
    feedback (the final block's plDDT head in place of the last)."""
    blocks = [f"three_track_{i}" for i in range(cfg.n_three_track_blocks - 1)]
    return ([f"two_track_{i}" for i in range(cfg.n_two_track_blocks)] + ["initial_coords"]
            + [f"{b}.{part}" for b in blocks for part in
               ("two_track", "coord_update_with_msa_and_pair", "msa_update_with_pair_and_coord")]
            + ["final_block.two_track", "final_block.coord_update_with_msa_and_pair",
               "final_block.plddt_head"])


def head_points(model) -> List[Tuple[str, str, str]]:
    """(key, module, "in" | "out") of the prediction head's capture points:
    the projection's output (its dropout module's), and in each ResNet its
    input, block_0's input (the stem's output), each block's output and the
    ResNet's output (the logits)."""
    head = "prediction_head"
    pts = [("head.proj", f"{head}.dropout", "out")]
    for h in HEADS:
        res = f"{head}.{h}_head"
        n = model.get_submodule(res).n
        pts += [(f"{h}.in", res, "in"), (f"{h}.stem", f"{res}.block_0", "in")]
        pts += [(f"{h}.block_{i}", f"{res}.block_{i}", "out") for i in range(n)]
        pts.append((f"{h}.logits", res, "out"))
    return pts


class Capture:
    def __init__(self, store=None):
        self.store = store  # None: each copy on its tensor's device
        self.kept: Dict[Tuple[int, str], object] = {}  # (L, key) -> copies

    def _copy(self, t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        return t.clone() if self.store is None else t.to(self.store, copy=True)

    def _store(self, L: int, key: str, obj):
        self.kept[(L, key)] = tree_map(self._copy, obj)

    def hooks(self, model, L: int):
        """Register the hooks on `model` for a request of length L; returns
        the handles (remove them after the request)."""
        names = stage_names(model.config)
        points = ([("embed", names[0], "in")] + [(n, n, "out") for n in names]
                  + head_points(model))
        handles = []
        for key, name, kind in points:
            mod = model.get_submodule(name)
            if kind == "in":
                h = mod.register_forward_pre_hook(
                    lambda m, args, key=key: self._store(L, key, args))
            else:
                h = mod.register_forward_hook(
                    lambda m, args, out, key=key: self._store(L, key, out))
            handles.append(h)
        return handles

    def result(self, L: int) -> Dict[str, object]:
        """{key: copy} of the capture at L; an "in" point's copy is its
        positional arguments."""
        return {key: v for (l, key), v in self.kept.items() if l == L}

    def drop(self, L: int):
        for k in [k for k in self.kept if k[0] == L]:
            del self.kept[k]
