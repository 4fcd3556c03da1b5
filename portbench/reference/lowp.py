"""The control's precision: the reference's matrix products with their
operands rounded to a lower precision, accumulated in float32 as a tensor
core does. "fp8": float8 e4m3 with one scale a tensor (its largest
magnitude at 448, the format's largest finite value); "tf32": 10 mantissa
bits, rounded to nearest; "bf16": bfloat16."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    x = x.float()
    if precision == "fp8":
        scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF  # round the low 13 of 23 mantissa bits away
        return bits.view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision {precision!r}")


_PRODUCTS = {F.linear, F.conv2d, torch.einsum, torch.matmul, torch.bmm, torch.mm,
             torch.Tensor.__matmul__, torch.Tensor.matmul, torch.Tensor.bmm, torch.Tensor.mm}


class LowPrecisionProducts(TorchFunctionMode):
    """Within this mode every matrix product and convolution rounds its
    floating-point operands to `precision` first."""

    def __init__(self, precision: str):
        super().__init__()
        self.precision = precision

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            r = lambda a: round_to(a, self.precision) if isinstance(a, torch.Tensor) else a
            if func is torch.einsum:
                args = (args[0],) + tuple(
                    [r(t) for t in a] if isinstance(a, (list, tuple)) else r(a) for a in args[1:])
            else:
                args = tuple(r(a) for a in args)
        return func(*args, **kwargs)
