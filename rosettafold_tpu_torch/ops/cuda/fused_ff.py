"""Fused pre-LN feed-forward residual (kernel D): wrapper of csrc/fused_ff.cu
and its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/fused_ff.py:
out = x + fc2(relu(fc1(LayerNorm(x)))) over the last axis of x (..., D), in
x's dtype (float32 or bfloat16). Weights in the JAX function's layout:
w1 (D, F), w2 (F, D) in x's dtype; gamma, beta, b1, b2 float32. The backward
is JAX's (`_bwd_rule`): the vjp of the plain version, recomputed.
"""

from __future__ import annotations

import ctypes

import torch

from ...models.layers import layer_norm
from . import build
from .grad import plain_vjp

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, ln_eps):
    """The kernel's math with its rounding points (JAX `_xla_composed`):
    LN rounded to x's dtype, the hidden rounded to it, float32 residual."""
    cdt = x.dtype
    y = layer_norm(x, gamma, beta, ln_eps).to(cdt)
    h = torch.relu(y.float() @ w1.float() + b1.float()).to(cdt)
    return (h.float() @ w2.float() + b2.float() + x.float()).to(cdt)


def _check(x, gamma, beta, w1, b1, w2, b2):
    D = x.shape[-1]
    F = w1.shape[-1]
    if w1.shape != (D, F) or w2.shape != (F, D) or b1.shape != (F,) or b2.shape != (D,) \
            or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"shapes: x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)} b1 {tuple(b1.shape)} b2 {tuple(b2.shape)}")
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"x, w1, w2 must share float32 or bfloat16: {x.dtype} {w1.dtype} "
                        f"{w2.dtype}")
    if any(t.dtype != torch.float32 for t in (gamma, beta, b1, b2)):
        raise TypeError("gamma, beta, b1, b2 must be float32")
    if len({t.device for t in (x, gamma, beta, w1, b1, w2, b2)}) != 1:
        raise ValueError("all operands must be on one device")


_fwd = None  # the C function, its argument types set once


def _fwd_fn():
    global _fwd
    if _fwd is None:
        fn = build.load("fused_ff").fused_ff_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fwd = fn
    return _fwd


def _launch(x, gamma, beta, w1, b1, w2, b2, ln_eps):
    global launches
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused FF kernel needs a contiguous, 16-byte aligned x")
    D, F = w1.shape
    if D != 288 or F % 64:
        raise ValueError(f"fused FF kernel takes D = 288 and F % 64 == 0: D={D} F={F}")
    M = x.numel() // D
    out = torch.empty_like(x)
    if M == 0:
        return out
    fn = _fwd_fn()
    w1k, w2k = w1.t().contiguous(), w2.t().contiguous()  # nn.Linear layout
    g, b, bb1, bb2 = (t.contiguous() for t in (gamma, beta, b1, b2))
    rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1k.data_ptr(), bb1.data_ptr(),
            w2k.data_ptr(), bb2.data_ptr(), out.data_ptr(), M, D, F, float(ln_eps),
            _DTYPES[x.dtype], build.stream_of(x))
    if rc:
        build.check(build.load("fused_ff"), rc, "fused_ff_fwd")
    launches += 1
    return out


def _forward(*args):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    x = args[0]
    if x.device.type == "cpu":
        return fused_ff_plain(*args)
    if x.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {x.device}")


class _FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, ln_eps):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.ln_eps = ln_eps
        return _forward(x, gamma, beta, w1, b1, w2, b2, ln_eps)

    @staticmethod
    def backward(ctx, gy):
        return (*plain_vjp(fused_ff_plain, ctx.saved_tensors, gy, ctx.ln_eps), None)


def fused_ln_ff_residual(x, gamma, beta, w1, b1, w2, b2, ln_eps):
    """x + FF(LayerNorm(x)), differentiable: the kernel on a CUDA tensor, the
    plain version on a CPU one; without grad mode the forward alone, outside
    autograd."""
    _check(x, gamma, beta, w1, b1, w2, b2)
    if not torch.is_grad_enabled():
        return _forward(x, gamma, beta, w1, b1, w2, b2, ln_eps)
    return _FusedFF.apply(x, gamma, beta, w1, b1, w2, b2, ln_eps)
