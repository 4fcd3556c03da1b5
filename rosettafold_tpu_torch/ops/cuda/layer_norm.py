"""Row LayerNorm (kernel LN): wrapper of csrc/layer_norm.cu.

y = (x - mu) * rsqrt(max(E[x^2] - mu^2, 0) + eps) * weight + bias over the
last axis of x (..., C), float32 statistics and a float32, contiguous y: the
function of `models/layers.py` `layer_norm`, its plain version. x is float32
or bfloat16, weight and bias float32 (C,). A view is read in place when its
last axis is contiguous and its leading axes fold into at most three strided
ones (`rows_of`). Forward only: the model takes it where autograd records
nothing (`models/layers.py` `norm`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rows_of(x):
    """x's rows as three leading axes, outermost first: ((n0, n1, n2), (s0,
    s1, s2)) in elements, axes of size 1 dropped, neighbours that step
    through memory as one axis folded, missing ones of size 1. Raises
    ValueError if more than three remain."""
    axes = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if axes and axes[-1][1] == s * n:
            axes[-1] = (axes[-1][0] * n, s)
        else:
            axes.append((n, s))
    if len(axes) > 3:
        raise ValueError(f"LN kernel reads rows over at most three strided axes: shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    axes = [(1, 0)] * (3 - len(axes)) + axes
    return tuple(n for n, _ in axes), tuple(s for _, s in axes)


def vector_loads(x, weight, bias, strides) -> bool:
    """Whether the kernel may read x in 16-byte vectors: C a multiple of 16
    bytes, x, weight, bias and every row start 16-byte aligned."""
    es = x.element_size()
    return ((x.shape[-1] * es) % 16 == 0 and x.data_ptr() % 16 == 0
            and weight.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0
            and all((s * es) % 16 == 0 for s in strides))


def _check(x, weight, bias):
    C = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16: {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"weight and bias must be float32: {weight.dtype} {bias.dtype}")
    if weight.shape != (C,) or bias.shape != (C,) or not weight.is_contiguous() \
            or not bias.is_contiguous():
        raise ValueError(f"weight and bias must be contiguous ({C},): {tuple(weight.shape)} "
                         f"{tuple(bias.shape)}")
    if x.stride(-1) != 1 and C > 1:
        raise ValueError(f"x's last axis must be contiguous: strides {x.stride()}")
    if len({x.device, weight.device, bias.device}) != 1:
        raise ValueError("x, weight and bias must be on one device")


_fwd = None  # the C function, its argument types set once


def _fwd_fn():
    global _fwd
    if _fwd is None:
        fn = build.load("layer_norm").layer_norm_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_void_p])
        _fwd = fn
    return _fwd


def _launch(x, weight, bias, eps):
    global launches
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    M = y.numel() // x.shape[-1]
    if M >= 2 ** 31:
        raise ValueError(f"LN kernel takes fewer than 2^31 rows: {M}")
    (_, n1, n2), strides = rows_of(x)
    rc = _fwd_fn()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), M,
                   x.shape[-1], n1, n2, *strides, float(eps), _DTYPES[x.dtype],
                   int(vector_loads(x, weight, bias, strides)), build.stream_of(x))
    if rc:
        build.check(build.load("layer_norm"), rc, "layer_norm_fwd")
    launches += 1
    return y


def fused_layer_norm(x, weight, bias, eps):
    """LayerNorm over x's last axis, float32 out: the kernel on a CUDA
    tensor, the plain version on a CPU one. Not differentiable."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        from ...models.layers import layer_norm

        return layer_norm(x, weight, bias, eps)
    if x.device.type == "cuda":
        return _launch(x, weight, bias, eps)
    raise ValueError(f"unsupported device {x.device}")
