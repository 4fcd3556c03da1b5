"""InstanceNorm over the pixels of NHWC maps (kernel IN): wrapper of
csrc/instance_norm.cu.

Two entry points, each the function of a plain version in `models/resnet.py`:
`instance_affine(y, weight, bias, eps) -> (inv, shift)` is `instance_stats`
(mean and biased variance over H x W; inv = weight / sqrt(var + eps), shift =
bias - mean * inv, each (B, C) float32), and `instance_apply(y, inv, shift,
x=None, out_dtype=None)` is `affine_elu_rows` without row chunks: elu([x +] y
* inv + shift) in float32, cast to out_dtype (y's dtype by default). y and x
are (B, H, W, C) float32 or bfloat16 of one dtype, contiguous, 16-byte
aligned, on the card, with C a multiple of 16 bytes and at most 288 vectors
of it; the wrappers raise on anything else. Forward only: `models/resnet.py`
`takes_kernel` decides where the model calls them (a CUDA tensor that
autograd records nothing of) and sends every other call to the plain
versions.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # entry-point calls that ran the kernel (the statistics are two launches)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECTORS = 288  # 16-byte vectors a pixel: one thread each, a block at most 288
PARTIALS_PER_SM = 8  # statistics workspace: partials of this many blocks an SM

_fns = {}  # C functions, their argument types set once
_sms = {}  # device index -> streaming multiprocessors


def _fn(name):
    if name not in _fns:
        fn = getattr(build.load("instance_norm"), name)
        fn.restype = ctypes.c_int
        if name == "instance_affine":
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                           + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def _check_map(y):
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32 or bfloat16: {y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"y must be (B, H, W, C): {tuple(y.shape)}")
    vec = y.shape[-1] * y.element_size()
    if vec % 16 or vec // 16 > MAX_VECTORS:
        raise ValueError(f"IN kernel takes C of a multiple of 16 bytes, at most {MAX_VECTORS}"
                         f" vectors: C={y.shape[-1]} {y.dtype}")


def _check_device(y, *rest):
    if len({t.device for t in (y, *rest) if t is not None}) != 1:
        raise ValueError("all operands must be on one device")
    if y.device.type != "cuda":
        raise ValueError(f"IN kernel runs on the card: {y.device}")


def _check_layout(*maps):
    for t in maps:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("IN kernel reads contiguous, 16-byte aligned tensors: shape "
                             f"{tuple(t.shape)} strides {t.stride()}")


def _sm_count(device):
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device.index]


def instance_affine(y, weight, bias, eps):
    """(inv, shift) of InstanceNorm over y's H x W pixels, each (B, C)
    float32, as `instance_stats` computes them."""
    global launches
    _check_map(y)
    B, H, W, C = y.shape
    for t in (weight, bias):
        if t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"weight and bias must be contiguous float32 ({C},): "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_device(y, weight, bias)
    _check_layout(y)
    if H * W == 0 or B == 0:
        raise ValueError(f"InstanceNorm of an empty map: {tuple(y.shape)}")
    blocks = max(B, PARTIALS_PER_SM * _sm_count(y.device))
    part = torch.empty(blocks * 2 * C, dtype=torch.float32, device=y.device)
    inv, shift = torch.empty((2, B, C), dtype=torch.float32, device=y.device)
    rc = _fn("instance_affine")(y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                part.data_ptr(), blocks, inv.data_ptr(), shift.data_ptr(), B,
                                H * W, C, float(eps), _DTYPES[y.dtype], build.stream_of(y))
    if rc:
        build.check(build.load("instance_norm"), rc, "instance_affine")
    launches += 1
    return inv, shift


def instance_apply(y, inv, shift, x=None, out_dtype=None):
    """elu([x +] y * inv + shift) in float32, cast to out_dtype (default y's):
    `affine_elu_rows` in one launch, without row chunks."""
    global launches
    out_dtype = out_dtype or y.dtype
    _check_map(y)
    B, H, W, C = y.shape
    if x is not None and (x.shape != y.shape or x.dtype != y.dtype):
        raise ValueError(f"x must have y's shape and dtype: {tuple(x.shape)} {x.dtype}")
    for t in (inv, shift):
        if t.dtype != torch.float32 or t.shape != (B, C):
            raise ValueError(f"inv and shift must be float32 ({B}, {C}): {t.dtype} "
                             f"{tuple(t.shape)}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16: {out_dtype}")
    _check_device(y, inv, shift, x)
    _check_layout(y, x, inv, shift)
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if out.numel() == 0:
        return out
    rc = _fn("instance_apply")(y.data_ptr(), None if x is None else x.data_ptr(),
                               inv.data_ptr(), shift.data_ptr(), out.data_ptr(), B, H * W, C,
                               _DTYPES[y.dtype], int(out_dtype == torch.float32),
                               build.stream_of(y))
    if rc:
        build.check(build.load("instance_norm"), rc, "instance_apply")
    launches += 1
    return out
