"""The traced pass: torch.profiler over a fixed part of the run, kept in
memory, reduced to device intervals by name and the host's operators.

`Trace` holds, for the pass: `window_s` (host clock, synchronised at both
ends), the device activities (name, start, end in ns on the profiler's
clock) and the host operators, from which `busy_s` (the union of device
intervals), kernel launches, device time by name, the longest idle gaps
and what the host was doing in each are read.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
NAME_CHARS = 200  # a kernel's name in the breakdown is cut to this many characters


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()) * 1000


@dataclass
class Trace:
    window_s: float
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # name, start, end
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        total, end = 0, None
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [d for d in self.device if not d[0].startswith(COPY_PREFIXES)]

    def device_s_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The n longest gaps between device activities, each named by the
        innermost host operator running at its middle."""
        dev = sorted(self.device, key=lambda t: t[1])
        gaps, end = [], None
        for _, s, e in dev:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            mid = (g0 + g1) // 2
            around = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(around, key=lambda h: h[2] - h[1])[0] if around else "(no host operator)"
            out.append((name[:NAME_CHARS], (g1 - g0) / 1e9))
        return out

    def top_device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        top = sorted(self.device_s_by_name().items(), key=lambda kv: -kv[1])[:n]
        return [(name[:NAME_CHARS], s) for name, s in top]


def traced(fn: Callable[[], object], cuda: bool = True):
    """(fn's result, Trace) with fn run under torch.profiler on the host and,
    with `cuda`, the card."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window_s = time.perf_counter() - t0
    tr = Trace(window_s=window_s)
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():  # a harness span, not device work
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                tr.host.append((ev.name(), _ns(ev, "start"), _ns(ev, "start") + _ns(ev, "duration")))
            continue
        start = _ns(ev, "start")
        rec = (ev.name(), start, start + _ns(ev, "duration"))
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            tr.device.append(rec)
        else:
            tr.host.append(rec)
    return result, tr


@contextlib.contextmanager
def span(name: str):
    """A host span of the harness's own, seen in the trace's host operators."""
    with torch.profiler.record_function(name):
        yield
