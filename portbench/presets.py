"""The configuration a request of length L runs, on both sides.

`program_config` asks the program for its own preset (what
`predict(preset=...)` runs at that L) and sets the widths the configuration
file states. `reference_config` is built from the file alone: its
`semantics` (compute dtype, scanned-block FAVOR+ seeds, SE(3) layout and
head row-chunking by length), computed in float32 on the plain path, with
the plain path's own row chunks at long L so that it fits. So a program
whose preset stops doing what the file says no longer matches the reference.
"""

from __future__ import annotations

import dataclasses

from .reference import config as rconfig

# the reference's row chunk for its axial attention and outer product above
# this length (the same math, in blocks of rows, so that float32 fits)
REF_LONG_CHUNK, REF_LONG_FROM = 128, 256


def _width_fields(cfg: dict) -> dict:
    w = dict(cfg["widths"])
    w["n_neighbors"] = tuple(w["n_neighbors"])
    w.pop("performer_dim_head")
    return w


def _by_length(cfg: dict, L: int) -> dict:
    for rule in cfg["semantics"]["by_length"]:
        if rule["up_to"] is None or L <= rule["up_to"]:
            return rule
    raise ValueError(f"no rule for L={L} in {cfg['name']}")


def program_config(cfg: dict, L: int):
    """The program's RoseTTAFoldConfig for a request of length L."""
    from rosettafold_tpu_torch import predict
    from rosettafold_tpu_torch.config import PerformerConfig, RoseTTAFoldConfig

    preset = cfg["program"]["preset"]
    if preset == "fast":
        base = predict.fast_config(L)
    elif preset == "exact":  # predict()'s default preset builds this
        base = RoseTTAFoldConfig(max_len=max(260, L))
    else:
        raise ValueError(f"unknown preset {preset!r}")
    return dataclasses.replace(
        base, **_width_fields(cfg),
        performer=PerformerConfig(dim_head=cfg["widths"]["performer_dim_head"]))


def reference_config(cfg: dict, L: int, **overrides):
    """The reference's configuration for a request of length L: float32, plain."""
    sem, rule = cfg["semantics"], _by_length(cfg, L)
    fields = dict(
        _width_fields(cfg), max_len=max(sem["max_len_min"], L), compute_dtype="float32",
        attn_impl="xla", scan_blocks=sem["scan_blocks"], se3_impl=rule["se3_impl"],
        head_chunk=rule["head_chunk"],
        long_chunk=REF_LONG_CHUNK if L > REF_LONG_FROM else None,
        performer=rconfig.PerformerConfig(dim_head=cfg["widths"]["performer_dim_head"]))
    fields.update(overrides)
    return rconfig.RoseTTAFoldConfig(**fields)


def semantic_fields(c) -> dict:
    """What must agree between the two sides' configurations: everything but
    the precision, the kernel switch and the row chunks."""
    skip = {"compute_dtype", "attn_impl", "long_chunk", "performer"}
    out = {f.name: getattr(c, f.name) for f in dataclasses.fields(c) if f.name not in skip}
    out["performer"] = dataclasses.asdict(c.performer)
    return out
