"""Fused 3x3 dilated SAME convolution, NHWC (kernel F): wrapper of
csrc/conv3x3.cu and its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/conv3x3.py, forward only:
x (B, H, W, C), w (3, 3, C, Co) HWIO in the JAX function's layout, pre None or
(inv, shift), each (B, C) float32: the pre-op elu(x * inv + shift) applied to
x before the conv. Out (B, H, W, Co) in `out_dtype`, which must be x's dtype
on the card. float32 and bfloat16; float32 accumulation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shift2d(t, dy, dx):
    """out[:, i, j] = t[:, i + dy, j + dx], zero outside the image."""
    B, H, W, C = t.shape
    out = torch.zeros_like(t)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[:, max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        t[:, max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def conv3x3_plain(x, w, pre, dilation, out_dtype):
    """The kernel's math (JAX `shifted_gemm_conv`): the pre-op, then nine
    shifted GEMMs of x's-dtype values accumulated in float32."""
    if pre is not None:  # elu(x * inv + shift) in float32, rounded to x's dtype
        inv, shift = pre
        x = F.elu(x.float() * inv[:, None, None, :] + shift[:, None, None, :]).to(x.dtype)
    d = dilation
    acc = None
    for ki in range(3):
        for kj in range(3):
            t = _shift2d(x, (ki - 1) * d, (kj - 1) * d).float() @ w[ki, kj].to(x.dtype).float()
            acc = t if acc is None else acc + t
    return acc.to(out_dtype)


def _check(x, w, pre, dilation):
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"x (B, H, W, C) and w (3, 3, C, Co): {tuple(x.shape)} "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x, w must share float32 or bfloat16: {x.dtype} {w.dtype}")
    if int(dilation) < 1:
        raise ValueError(f"dilation {dilation}")
    ops = [x, w]
    if pre is not None:
        inv, shift = pre
        if inv.shape != (x.shape[0], x.shape[-1]) or shift.shape != inv.shape:
            raise ValueError(f"pre must be two (B, C) arrays: {tuple(inv.shape)}")
        if inv.dtype != torch.float32 or shift.dtype != torch.float32:
            raise TypeError("pre must be float32")
        ops += [inv, shift]
    if len({t.device for t in ops}) != 1:
        raise ValueError("all operands must be on one device")


def _launch(x, w, pre, dilation, out_dtype):
    global launches
    if out_dtype != x.dtype:
        raise TypeError(f"conv kernel writes x's dtype: {out_dtype} != {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv kernel needs a contiguous, 16-byte aligned x")
    B, H, W, C = x.shape
    Co = w.shape[-1]
    if Co != 288 or C % 96:
        raise ValueError(f"conv kernel takes Co = 288 and C % 96 == 0: C={C} Co={Co}")
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("conv3x3")
    wk = w.permute(0, 1, 3, 2).contiguous()  # (3, 3, Co, C): [tap][co][ci]
    pre_arr = None if pre is None else torch.stack(pre, 1).contiguous()  # (B, 2, C)
    fn = lib.conv3x3_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = fn(build.ptr(x), build.ptr(wk),
            None if pre_arr is None else build.ptr(pre_arr), build.ptr(out),
            B, H, W, C, Co, int(dilation), _DTYPES[x.dtype], build.stream_of(x))
    build.check(lib, rc, "conv3x3_fwd")
    launches += 1
    return out


def conv3x3_fused(x, w, pre=None, dilation=1, out_dtype=None):
    """3x3 dilated SAME conv with the optional pre-op: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    out_dtype = out_dtype or x.dtype
    _check(x, w, pre, dilation)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, pre, dilation, out_dtype)
    if x.device.type == "cuda":
        return _launch(x, w, pre, dilation, out_dtype)
    raise ValueError(f"unsupported device {x.device}")
