"""By the AST: no module of the benchmark but its tests imports JAX or the
JAX package, and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "rosettafold_tpu"}


def _modules():
    for dirpath, _, files in os.walk(HERE):
        if os.path.basename(dirpath) == "tests" or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), HERE)


def _imports(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()))
def test_no_jax_and_a_program_free_reference(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if path.startswith("reference" + os.sep) or path.startswith("counts" + os.sep):
        assert "rosettafold_tpu_torch" not in names, path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import sys

    from portbench import run

    monkeypatch.setitem(sys.modules, "rosettafold_tpu_torch_x", sys)
    assert "rosettafold_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rosettafold_tpu.config", sys)
    assert run.forbidden_modules() == ["rosettafold_tpu"]
