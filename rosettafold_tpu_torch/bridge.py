"""flax parameters -> this port's state_dict.

The inverse of rosettafold_tpu/utils/torch_import.py's layout rules:
Dense kernel (in, out) -> Linear weight (out, in); Conv kernel HWIO -> OIHW;
LayerNorm / InstanceNorm `scale` -> `weight`; Embed `embedding` -> `weight`;
`bias` and the SE(3) direct parameters (`W_d`, `bias_d`) carry over. The port's
module names follow the flax tree, so the path is the key. Scanned checkpoints
(`two_track_scan` / `three_track_scan`) are unstacked in numpy first, like
`rosettafold_tpu.utils.scan_convert.adapt_params(..., want_scanned=False)`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def unstack_scanned(params: Dict[str, Any]) -> Dict[str, Any]:
    """scan_blocks layout -> per-block layout (numpy)."""
    out = {k: v for k, v in params.items() if k not in ("two_track_scan", "three_track_scan")}
    for scan, name in (("two_track_scan", "two_track"), ("three_track_scan", "three_track")):
        if scan in params:
            block = params[scan]["block"]
            for i in range(np.shape(_first_leaf(block))[0]):
                out[f"{name}_{i}"] = _tree_map(lambda a, i=i: np.asarray(a)[i], block)
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(path, value):
    *mods, leaf = path
    v = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if v.ndim == 2:
            v = v.T
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {v.ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), v


def state_dict_from_flax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a flax `params` tree, or {"params": tree}) ->
    state_dict of `RoseTTAFold(cfg)`. Loads strictly: any missing or
    unexpected key, or a shape that differs, raises."""
    from .models.rosettafold import RoseTTAFold

    if "params" in params:
        params = params["params"]
    params = unstack_scanned(params)
    sd = {}
    for path, value in _flatten(params):
        key, v = _convert(path, value)
        sd[key] = torch.from_numpy(np.array(v, copy=True))
    with torch.device("meta"):
        expected = RoseTTAFold(cfg, init=False).state_dict()
    missing = sorted(set(expected) - set(sd))
    unexpected = sorted(set(sd) - set(expected))
    if missing or unexpected:
        raise KeyError(f"flax params do not match the port: missing {missing[:8]}"
                       f" ({len(missing)}), unexpected {unexpected[:8]} ({len(unexpected)})")
    for k, t in expected.items():
        if tuple(t.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(sd[k].shape)} != port {tuple(t.shape)}")
    return sd


def module_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The same leaf conversion for one module's flax params (no unstacking,
    no key check): for loading a single ported module."""
    if "params" in params:
        params = params["params"]
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in (_convert(p, x) for p, x in _flatten(params))}
