"""The map from device kernel names, as the profiler reports them, to the
port's hand-written kernels: one file a kernel (`<kernel>.json`), whose
`names` each match every device kernel whose name holds it. A PR that
renames or adds a kernel adds an entry or a file."""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def patterns() -> Dict[str, List[str]]:
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        out[d["kernel"]] = list(d["names"])
    return out


def kernel_of(name: str, pats: Dict[str, List[str]]):
    """The port kernel a device kernel belongs to, or None (plain PyTorch)."""
    for k, names in pats.items():
        if any(n in name for n in names):
            return k
    return None
