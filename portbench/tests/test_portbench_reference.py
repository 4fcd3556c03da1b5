"""The frozen reference against the port's plain path, the control's
precision, and a run whose timed path is broken coming out not correct."""

from __future__ import annotations

import argparse

import pytest
import torch

from portbench import check, run, serve, weights
from portbench.reference.config import tiny_config as ref_tiny
from portbench.reference.lowp import LowPrecisionProducts, round_to
from portbench.reference.models.rosettafold import RoseTTAFold as Reference
from portbench.tests.conftest import tiny_cell
from rosettafold_tpu_torch.config import tiny_config
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold as Port


@pytest.mark.parametrize("se3_impl", ["dense", "bucket"])
def test_reference_equals_the_port_plain_path(se3_impl):
    ref = Reference(ref_tiny(se3_impl=se3_impl), init=False)
    sd = weights.draw(ref, 2 ** 33 + 3)
    port = Port(tiny_config(se3_impl=se3_impl), init=False)
    port.load_state_dict(sd, strict=True)
    L, N = 36, 6
    msa = torch.randint(0, 21, (1, N, L), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = ref(msa, msa[:, 0], torch.arange(L)[None])
        b = port(msa, msa[:, 0], torch.arange(L)[None])
    for k in a[0]:
        torch.testing.assert_close(a[0][k], b[0][k], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a[1], b[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-5)


def test_weights_are_a_function_of_the_seed():
    a = weights.draw(Reference(ref_tiny(), init=False), 5)
    b = weights.draw(Reference(ref_tiny(), init=False), 5)
    c = weights.draw(Reference(ref_tiny(), init=False), 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].abs().sum() > 0)


@pytest.mark.parametrize("precision,err", [("fp8", 3e-2), ("bf16", 2e-3), ("tf32", 3e-4)])
def test_control_precisions_round_their_operands(precision, err):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    g = float((round_to(x, precision) - x).norm() / x.norm())
    assert err / 8 < g < err
    w = torch.randn(32, 64)
    with LowPrecisionProducts(precision):
        y = torch.nn.functional.linear(x, w)
    assert torch.equal(y, round_to(x, precision) @ round_to(w, precision).t())


def _run(name, trace=0, **kw):
    man, cell, cfg, mix = tiny_cell(name, **kw)
    cfg["limits"] = {"pair": 0.05, "msa": 0.1, "head": 0.1, "logits": 0.1}
    args = argparse.Namespace(workload=name, seed=2 ** 33 + 11, seconds=3.0, trace=trace)
    return run.execute(args, man, cell, cfg, mix, device="cpu")


def test_a_sound_run_is_correct_and_reports_its_metrics():
    res = _run("fold-short")
    assert res["correct"] and res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"fold_p90_ms", "setup_s"}
    assert list(res)[-1] == "checks"


def test_the_traced_run_reads_its_per_layer_metrics():
    res = _run("fold-short", trace=1)
    assert res["correct"]
    assert "mfu.fold-short" in res["metrics"] and res["device"]["window_s"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """The timed path broken underneath: one stage of the program returns a
    slightly altered pair stream; the run has to come out not correct."""
    from rosettafold_tpu_torch.models import rosettafold as port_model

    real = port_model.TwoTrackBlock.forward

    def altered(self, msa, pair):
        msa, pair = real(self, msa, pair)
        return msa, pair * 1.1

    monkeypatch.setattr(port_model.TwoTrackBlock, "forward", altered)
    assert not _run("fold-short")["correct"]


def test_a_head_block_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """The prediction head's residual blocks are checked one by one."""
    from rosettafold_tpu_torch.models import resnet as port_resnet

    real = port_resnet.ResBlock2D.forward
    monkeypatch.setattr(port_resnet.ResBlock2D, "forward", lambda self, x: real(self, x) * 1.1)
    res = _run("fold-short")
    assert not res["correct"] and res["checks"]["head"]["value"] > 0.05


def test_a_stage_that_returns_its_input_unchanged_is_not_correct(monkeypatch):
    from rosettafold_tpu_torch.models import rosettafold as port_model

    monkeypatch.setattr(port_model.TwoTrackBlock, "forward", lambda self, msa, pair: (msa, pair))
    assert not _run("fold-short")["correct"]


def test_the_reference_against_itself_reads_zero():
    man, cell, cfg, mix = tiny_cell("fold-short", lengths=(20,), groups=((20,),))
    fc = serve.FoldCell(cfg, mix, 9, "cpu", None)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        fc.tmp = tmp
        fc.setup()
        cap = check.control_capture(cfg, fc.weights, fc.files[20], mix["n_seq"],
                                    mix["subsample"], "cpu", None)
        gaps = check.stage_gaps(cfg, fc.weights, fc.files[20], mix["n_seq"], mix["subsample"],
                                "cpu", cap)
    assert max(gaps.values()) == 0.0
