"""One reader a per-layer metric: `metrics/<name>.py`, found by the name
that BENCHMARK.json gives it, with `read(ctx)` (see readers.py); its layer,
unit, the end-to-end metric it moves and its cells are the manifest's."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def of_cell(man: dict, cell: str, kind: str):
    """The manifest's metrics of `kind` ("end_to_end" or "per_layer") that
    the cell reports."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def load(name: str):
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
