"""What a per-layer metric's reader (`metrics/<name>.py`) reads: the traced
pass and the harness's own counts of it. A reader returns None where it
finds nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import kernels
from .trace import Trace


@dataclass
class Context:
    trace: Trace
    items: int  # requests or steps completed in the traced pass
    model_flops: float  # of those items, by counts.model
    peak_flops: float  # the configuration's precision, published
    favor_bound_s: Optional[float] = None  # least time of the pass's FAVOR+ launches

    def launches_per_item(self) -> Optional[float]:
        n = len(self.trace.kernels())
        return n / self.items if n and self.items else None

    def idle_share_pct(self) -> Optional[float]:
        if not self.trace.device or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def mfu_pct(self) -> Optional[float]:
        if not self.model_flops or self.trace.window_s <= 0:
            return None
        return 100.0 * self.model_flops / (self.trace.window_s * self.peak_flops)

    def kernel_device_s(self, kernel: str) -> float:
        pats = {kernel: kernels.patterns()[kernel]}
        return sum(e - s for n, s, e in self.trace.kernels() if kernels.kernel_of(n, pats)) / 1e9

    def plain_device_s(self) -> float:
        pats = kernels.patterns()
        return sum(e - s for n, s, e in self.trace.kernels()
                   if kernels.kernel_of(n, pats) is None) / 1e9

    def roofline_pct(self, kernel: str, bound_s: Optional[float]) -> Optional[float]:
        t = self.kernel_device_s(kernel)
        if not bound_s or t <= 0:
            return None
        return 100.0 * bound_s / t
