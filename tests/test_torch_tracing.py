"""The port's profiler spans (`rosettafold_tpu_torch.tracing`): nothing
entered without a profiler, every span of a request once under one, nested
as named, outputs unchanged; and the model-build counter."""

from __future__ import annotations

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rosettafold_tpu_torch import tracing
from rosettafold_tpu_torch.config import tiny_config
from rosettafold_tpu_torch.models import rosettafold
from rosettafold_tpu_torch.predict import predict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
from make_demo_a3m import make  # noqa: E402

CFG = tiny_config()
PREDICT = ["rf.predict", "rf.predict.featurize", "rf.predict.build", "rf.predict.to_device",
           "rf.predict.forward", "rf.predict.sync"]
# the tiny config: one two-track block, one three-track block and the final block
STAGES = ["rf.two_track_0", "rf.initial_coords", "rf.three_track_0",
          "rf.three_track_0.two_track", "rf.three_track_0.coord_update_with_msa_and_pair",
          "rf.three_track_0.coord_update_with_msa_and_pair.se3",
          "rf.three_track_0.msa_update_with_pair_and_coord", "rf.final_block",
          "rf.final_block.two_track", "rf.final_block.coord_update_with_msa_and_pair",
          "rf.final_block.coord_update_with_msa_and_pair.se3", "rf.final_block.plddt_head",
          "rf.prediction_head"]


def _raise(name):
    raise AssertionError(f"record_function({name!r}) entered with no profiler running")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One request with no profiler (record_function made to raise) and the
    same request under torch.profiler, each building its model: (outputs off,
    outputs on, spans, models built)."""
    a3m = str(tmp_path_factory.mktemp("a3m") / "t.a3m")
    make(a3m, L=24, n_seq=8, seed=3)

    def run():
        return predict(a3m, n_seq=8, config=CFG, device="cpu", seed=5)[:3]

    builds = rosettafold.builds
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _raise)
        off = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return off, on, spans, rosettafold.builds - builds


def test_span_enters_nothing_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with tracing.span("rf.test"):
        pass


def test_request_gives_each_span_once_nested_by_name(served):
    spans = served[2]
    names = [n for n, _, _ in spans]
    assert sorted(names) == sorted(PREDICT + ["rf.embed"] + STAGES)
    paths = dict(rosettafold.RoseTTAFold(CFG, init=False).named_modules())
    assert all(n[len("rf."):] in paths for n in STAGES)
    at = {n: (s, e) for n, s, e in spans}
    for name, (s, e) in at.items():
        if name == "rf.predict":
            continue
        parent = name.rsplit(".", 1)[0]
        if parent not in at:  # a top-level stage of the forward
            parent = "rf.predict.forward"
        ps, pe = at[parent]
        assert ps <= s <= e <= pe, (name, parent)


def test_outputs_bit_equal_with_the_profiler_on_and_off(served):
    off, on = served[:2]
    logits_off, *rest_off = off
    logits_on, *rest_on = on
    assert logits_off.keys() == logits_on.keys()
    for k in logits_off:
        assert torch.equal(logits_off[k], logits_on[k]), k
    for a, b in zip(rest_off, rest_on):
        assert torch.equal(a, b)


def test_each_build_counts_once_with_its_seconds(served):
    assert served[3] == 2  # predict built a model for each request
    n, s = rosettafold.builds, rosettafold.build_s
    rosettafold.RoseTTAFold(CFG, init=False)
    assert rosettafold.builds == n + 1
    assert rosettafold.build_s > s
