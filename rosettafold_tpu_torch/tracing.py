"""Named spans of the serving path, for PyTorch's own profiler.

`span(name)` marks a stretch of host code as a profiler annotation, so it
lands in the same trace as the card's kernels, on one clock. It costs only a
check while no profiler records: without one it enters nothing.

Read the spans with `torch.profiler.profile(activities=[CPU, CUDA])` around
`predict.predict(...)` (each `record_function` range appears as a user
annotation beside the kernels it launched), or run the program under Nsight
Systems inside `torch.autograd.profiler.emit_nvtx()`, which turns the same
annotations into NVTX ranges.

The names: `rf.predict` is one request (the port serves one at a time), with
its children `rf.predict.build` (only when `predict` builds the model),
`.featurize` (A3M parse and features), `.to_device`, `.forward` and `.sync`.
Inside the forward, `rf.embed`, then one span per stage named `rf.` plus the
stage's path in `RoseTTAFold.named_modules()`: `rf.two_track_{i}`,
`rf.initial_coords`, `rf.three_track_{i}` and `rf.final_block` (each with
its `.two_track`, `.coord_update_with_msa_and_pair` and
`.msa_update_with_pair_and_coord` or `.plddt_head`, and the coordinate
update's `.se3`), `rf.prediction_head`.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: `torch.profiler.record_function(name)` while the
    autograd profiler records (torch.profiler or emit_nvtx), else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
