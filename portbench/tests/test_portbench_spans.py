"""The readers of the program's spans and set-up counter on a hand-made
trace (spans and device intervals with known overlaps), and on a traced
run on the CPU."""

from __future__ import annotations

import pytest

from portbench import metrics as readers
from portbench import spans
from portbench.readers import Context
from portbench.tests.test_portbench_reference import _run
from portbench.trace import Trace

MS = 1_000_000  # ns

# two requests; times in ms on the profiler's clock
HOST = [
    ("portbench.request L=64", 0, 40),
    ("rf.predict", 0, 40), ("rf.predict.featurize", 1, 3), ("rf.predict.to_device", 3, 4),
    ("rf.predict.forward", 4, 20), ("rf.embed", 4, 6), ("rf.two_track_0", 6, 20),
    ("cudaLaunchKernel", 5, 5), ("cudaLaunchKernel", 7, 7), ("cuLaunchKernel", 12, 12),
    ("rf.predict.sync", 20, 30),
    ("portbench.request L=96", 40, 80),
    ("rf.predict", 40, 80), ("rf.predict.featurize", 41, 44), ("rf.predict.to_device", 44, 46),
    ("rf.predict.forward", 46, 60), ("rf.embed", 46, 50), ("rf.two_track_0", 50, 60),
    ("cudaLaunchKernel", 51, 51), ("rf.predict.sync", 60, 70),
]
DEVICE = [  # each request's to_device copies end as its span ends: the clocks agree
    ("Memcpy HtoD (Pageable -> Device)", 3, 4),
    ("k", 5, 8), ("k", 7, 10), ("k", 12, 25),  # forward 4-20 busy 5-10, 12-20: 13 of 16
    ("Memcpy HtoD (Pageable -> Device)", 45, 45.5), ("Memcpy HtoD (Pageable -> Device)", 45.5, 46),
    ("k", 47, 49), ("k", 48, 52), ("k", 58, 65),  # forward 46-60 busy 47-52, 58-60: 7 of 14
]


def _trace(skew=(0, 0)):
    """The trace, with the device's clock running skew[i] ms late in request i."""
    ns = lambda rows: [(n, int(s * MS), int(e * MS)) for n, s, e in rows]  # noqa: E731
    dev = [(n, s + skew[s >= 40], e + skew[s >= 40]) for n, s, e in DEVICE]
    return Trace(window_s=0.08, device=ns(dev), host=ns(HOST))


def _ctx(items=2, skew=(0, 0)):
    return Context(trace=_trace(skew), items=items, model_flops=0.0, peak_flops=1.0)


@pytest.mark.parametrize("cell", ["fold-short", "fold-long"])
def test_entry_and_dispatch_idle_a_request(cell):
    # entry: (2 + 1) + (3 + 2) ms over 2 requests; idle: (16 - 13) + (14 - 7) over 2
    assert readers.load(f"entry_ms.{cell}").read(_ctx()) == pytest.approx(4.0)
    assert readers.load(f"dispatch_idle_ms.{cell}").read(_ctx()) == pytest.approx(5.0)


@pytest.mark.parametrize("skew", [(3, 3), (2, -1), (-0.5, 12)])
def test_device_clock_offset_is_read_at_each_request_copies(skew):
    """The device's clock late or early by a different amount in each
    request reads as in step with the host."""
    assert [d for _, _, d in spans.offsets(_trace(skew))] == [skew[0] * MS, skew[1] * MS]
    assert readers.load("dispatch_idle_ms.fold-long").read(_ctx(skew=skew)) == (
        pytest.approx(5.0))
    rows = {r["span"]: r for r in spans.stage_table(_trace(skew), 2)}
    assert rows["rf.two_track_0"]["idle_ms"] == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["entry_ms.fold-short", "dispatch_idle_ms.fold-short",
                                  "entry_ms.fold-long", "dispatch_idle_ms.fold-long"])
@pytest.mark.parametrize("items", [1, 3, 0])
def test_readers_give_none_unless_one_forward_span_a_request(name, items):
    assert readers.load(name).read(_ctx(items)) is None


def test_a_program_without_spans_reads_none():
    ctx = _ctx()
    ctx.trace.host = [h for h in ctx.trace.host if not h[0].startswith("rf.")]
    assert readers.load("entry_ms.fold-short").read(ctx) is None
    assert readers.load("dispatch_idle_ms.fold-long").read(ctx) is None


def test_stage_table_splits_host_idle_and_launches():
    rows = {r["span"]: r for r in spans.stage_table(_trace(), 2)}
    assert list(rows)[:3] == ["rf.predict", "rf.predict.featurize", "rf.predict.to_device"]
    tt = rows["rf.two_track_0"]  # 6-20 (busy 6-10, 12-20) and 50-60 (busy 50-52, 58-60)
    assert tt["host_ms"] == pytest.approx((14 + 10) / 2)
    assert tt["idle_ms"] == pytest.approx((2 + 6) / 2)
    assert tt["launches"] == pytest.approx((2 + 1) / 2)
    assert rows["rf.embed"]["launches"] == pytest.approx(0.5)
    assert rows["rf.predict.forward"]["count"] == 1.0


def test_build_seconds_read_from_the_program_counter(monkeypatch):
    from rosettafold_tpu_torch.models import rosettafold

    monkeypatch.setattr(rosettafold, "builds", 6)
    monkeypatch.setattr(rosettafold, "build_s", 12.5)
    assert readers.load("build_s.fold-long").read(_ctx()) == 12.5
    monkeypatch.setattr(rosettafold, "builds", 0)
    assert readers.load("build_s.fold-long").read(_ctx()) is None
    monkeypatch.delattr(rosettafold, "builds")  # a program without the counter
    assert readers.load("build_s.fold-long").read(_ctx()) is None


def test_a_traced_run_reads_the_program_spans_and_counter():
    """On the CPU no device interval is seen: the whole forward reads idle."""
    res = _run("fold-long", trace=1, lengths=(20,), groups=((20,),))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["entry_ms.fold-long"] < m["dispatch_idle_ms.fold-long"]
    assert m["build_s.fold-long"] > 0
    assert res["breakdown"]["idle_gaps"] == []
