"""BENCHMARK.json and the files it names: parse, names and units, and every
configuration, mix and per-layer metric found by its name."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import sys
import types

import pytest

from portbench import metrics as readers
from portbench import check, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = run.manifest()
ALL_METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["portbench"]
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert "setup_s" in [m["name"] for m in MAN["end_to_end"]]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_and_reports_its_metrics(cell):
    got, cfg, mix = run.find_cell(MAN, cell["name"])
    assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
    assert cell["chips"] == 1
    e2e = [m["name"] for m in run.metrics_of(MAN, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(MAN, cell["name"], "per_layer")
    for key in check.limits(cfg, mix):
        assert key in check.NUMBERS


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_agrees_and_moves_a_reported_metric(metric):
    mod = readers.load(metric["name"])
    assert callable(mod.read)
    assert not {"LAYER", "UNIT", "MOVES", "WORKLOADS"} & set(vars(mod)), "the manifest's to say"
    for cell in metric["workloads"]:
        reported = [m["name"] for m in run.metrics_of(MAN, cell, "end_to_end")]
        assert metric["moves"] in reported


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A later PR adds files and entries and edits no file already there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(run.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    cfg = json.load(open(root / "portbench/configs/rf-serve.json"))
    cfg["name"] = "rf-serve-new"
    json.dump(cfg, open(root / "portbench/configs/rf-serve-new.json", "w"))
    mix = json.load(open(root / "portbench/mixes/short.json"))
    mix.update(name="short-new", lengths=[160, 192])
    json.dump(mix, open(root / "portbench/mixes/short-new.json", "w"))
    (root / "portbench/metrics/idle_share.fold-new.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    man["configs"].append({"name": "rf-serve-new", "source": "x", "reduced": [], "why": "x",
                           "file": "portbench/configs/rf-serve-new.json"})
    man["workloads"].append({"name": "fold-new", "config": "rf-serve-new",
                             "traffic": "short-new", "chips": 1, "why": "x"})
    man["end_to_end"][1]["workloads"].append("fold-new")
    man["per_layer"].append({"name": "idle_share.fold-new", "unit": "%", "better": "lower",
                             "source": "device_trace", "layer": "Device",
                             "moves": "fold_pairs_per_s", "workloads": ["fold-new"]})
    json.dump(man, open(root / "BENCHMARK.json", "w"))
    monkeypatch.setattr(run, "ROOT", str(root))
    monkeypatch.setattr(run, "HERE", str(root / "portbench"))
    monkeypatch.setattr(readers, "HERE", str(root / "portbench/metrics"))
    cell, cfg2, mix2 = run.find_cell(run.manifest(), "fold-new")
    assert cfg2["name"] == "rf-serve-new" and mix2["lengths"] == [160, 192]
    assert [m["name"] for m in run.metrics_of(run.manifest(), "fold-new", "per_layer")] == [
        "idle_share.fold-new"]
    assert readers.load("idle_share.fold-new").read(None) == 42.0


def test_a_new_loop_is_found_by_the_name_its_mix_gives(monkeypatch):
    """A mix names its loop; run.py takes `portbench.loops.<loop>` with no edit."""
    loop = types.ModuleType("portbench.loops.echo")
    loop.run = lambda args, cell, cfg, mix, man, tmp, device, t_start: (
        2, 0, {"setup_s": 1.5, "fold_p90_ms": 3.0}, {"memory_peak_bytes": 7}, None,
        {"step": {"loss": 0.25}})
    monkeypatch.setitem(sys.modules, "portbench.loops.echo", loop)
    cell, cfg, mix = run.find_cell(MAN, "fold-short")
    cfg, mix = dict(cfg, limits={"loss": 0.5}), dict(mix, loop="echo")
    args = types.SimpleNamespace(trace=0)
    res = run.execute(args, MAN, cell, cfg, mix, device="cpu")
    assert res["correct"] and res["attempted"] == 2
    assert res["checks"] == {"loss": {"value": 0.25, "limit": 0.5}}
    res = run.execute(args, MAN, cell, dict(cfg, limits={"loss": 0.1}), mix, device="cpu")
    assert not res["correct"]


@pytest.mark.parametrize("loop", sorted({run.find_cell(MAN, c["name"])[2]["loop"]
                                         for c in MAN["workloads"]}))
def test_every_mix_names_a_loop_module(loop):
    assert callable(importlib.import_module(f"portbench.loops.{loop}").run)


def test_mix_files_hold_only_parameters():
    for name in os.listdir(os.path.join(run.HERE, "mixes")):
        mix = json.load(open(os.path.join(run.HERE, "mixes", name)))
        assert mix["name"] + ".json" == name
        assert max(mix["lengths"]) in mix["check_groups"][-1]
        assert set(sum(mix["check_groups"], [])) <= set(mix["lengths"])
