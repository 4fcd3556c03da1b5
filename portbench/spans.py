"""The program's own spans in a traced pass, against the card's intervals.

The port marks each request and each stage of its forward with profiler
annotations (`rosettafold_tpu_torch.tracing`), which `trace.traced` keeps in
`Trace.host` beside the harness's own span. Here: the time a set of spans
lasts, the part of it in which no device activity ran, and the kernel
launches the host issued inside it. Every figure is a request's share: the
readers return None unless the pass holds one `rf.predict.forward` span a
request (a program without the spans has none).

The host's and the device's timestamps drift apart inside a pass: on an
H100 machine the device's ran up to 22 ms late (or 5 ms early) against the
host spans over a few seconds, then fell back (PERF.md §7). So each request's device time is
set against its spans through an anchor both clocks see: the pageable
host-to-device copies of `rf.predict.to_device`, which end on the device
just before the span ends on the host. The offset read there is taken off
every span of the request before it meets the device intervals; the launch
counts compare host times alone and need none.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

PREDICT = "rf.predict"
FORWARD = "rf.predict.forward"
TO_DEVICE = "rf.predict.to_device"
ENTRY = ("rf.predict.featurize", TO_DEVICE)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # host-side runtime and driver calls
COPY = "Memcpy HtoD"
ANCHOR_NS = 50_000_000  # how far from its span a request's copies are looked for

Interval = Tuple[int, int]


def of(trace, names: Sequence[str]) -> List[Interval]:
    """(start, end) in ns of every host span named one of `names`."""
    return [(s, e) for n, s, e in trace.host if n in names]


def union(intervals) -> List[Interval]:
    """The intervals merged into disjoint ones, in order."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(merged: List[Interval], starts: List[int], s: int, e: int) -> int:
    """ns of [s, e] that the disjoint, ordered `merged` (with `starts` their
    starts) covers."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0
    while i < len(merged) and merged[i][0] < e:
        total += max(0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return total


def offsets(trace) -> List[Tuple[int, int, int]]:
    """(start, end, offset) of each `rf.predict` span: the device's clock
    less the host's at its `to_device` span, read as the end of the run of
    host-to-device copies nearest the span's start less the span's end; 0
    where the request shows no copy (a trace of the host alone)."""
    dev = sorted(trace.device, key=lambda d: d[1])
    copies = [i for i, d in enumerate(dev) if d[0].startswith(COPY)]
    to_device = sorted(of(trace, (TO_DEVICE,)))
    out = []
    for ps, pe in sorted(of(trace, (PREDICT,))):
        delta = 0
        mine = [t for t in to_device if ps <= t[0] <= pe]
        if mine:
            ts, te = mine[0]
            near = [i for i in copies if abs(dev[i][1] - ts) <= ANCHOR_NS]
            if near:
                j = min(near, key=lambda i: abs(dev[i][1] - ts))
                while j + 1 < len(dev) and dev[j + 1][0].startswith(COPY):
                    j += 1
                delta = dev[j][2] - te
        out.append((ps, pe, delta))
    return out


class Idle:
    """The pass's device intervals merged once, for the idle time of spans,
    each span moved onto the device's clock by its request's offset."""

    def __init__(self, trace):
        self.merged = union((s, e) for _, s, e in trace.device)
        self.starts = [s for s, _ in self.merged]
        self.requests = offsets(trace)
        self.request_starts = [r[0] for r in self.requests]

    def offset(self, s: int) -> int:
        i = bisect.bisect_right(self.request_starts, s) - 1
        if i >= 0 and s <= self.requests[i][1]:
            return self.requests[i][2]
        return 0

    def ns(self, spans: Sequence[Interval]) -> int:
        """Σ over the spans of their length less the device time inside them."""
        total = 0
        for s, e in spans:
            d = self.offset(s)
            total += e - s - covered(self.merged, self.starts, s + d, e + d)
        return total


def per_request_ms(ctx, ns: int) -> Optional[float]:
    if not ctx.items or len(of(ctx.trace, (FORWARD,))) != ctx.items:
        return None
    return ns / 1e6 / ctx.items


def entry_ms(ctx) -> Optional[float]:
    """A3M parse, featurize and host-to-device copies, a request."""
    return per_request_ms(ctx, sum(e - s for s, e in of(ctx.trace, ENTRY)))


def dispatch_idle_ms(ctx) -> Optional[float]:
    """Time inside the forward's span with no device activity, a request:
    the card waiting on the host's dispatch."""
    return per_request_ms(ctx, Idle(ctx.trace).ns(of(ctx.trace, (FORWARD,))))


def stage_table(trace, items: int) -> List[Dict[str, float]]:
    """One row a program span name (`rf.*`), in order of first start: host
    ms, device-idle ms and kernel launches (host-side launch calls starting
    inside it), each a request's share of the pass."""
    idle = Idle(trace)
    launches = sorted(s for n, s, _ in trace.host if n.startswith(LAUNCHES))
    spans: Dict[str, List[Interval]] = {}
    for n, s, e in sorted(trace.host, key=lambda h: h[1]):
        if n.startswith("rf."):
            spans.setdefault(n, []).append((s, e))
    rows = []
    for name, iv in spans.items():
        n_launch = sum(bisect.bisect_left(launches, e) - bisect.bisect_left(launches, s)
                       for s, e in iv)
        rows.append({"span": name, "count": len(iv) / items,
                     "host_ms": sum(e - s for s, e in iv) / 1e6 / items,
                     "idle_ms": idle.ns(iv) / 1e6 / items, "launches": n_launch / items})
    return rows
