"""Generalized FAVOR+ linear attention (kernel H): wrapper of
csrc/linear_attention.cu and its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/linear_attention.py
`generalized_linear_attention(q, k, v, projection, kernel_eps=1e-3)`: q, k,
v (P, L, dh), already scaled by dh^-0.25; projection (m, dh). Per problem,
phi(x) = relu(x P^T) + eps, ctx = phi(k)^T v, and out = phi(q) ctx /
max(phi(q) sum_L phi(k), 1e-12), returned in q's dtype. The feature maps,
ctx and the normalizer stay in float32 for bfloat16 inputs, as in the TPU
kernel (`_forward`, :41-68), not in the reference's dtypes (`_xla_reference`
adds 1e-12 instead). On the card, bfloat16 runs on wgmma and carries those
float32 values through a bf16 high/low split, so that only the output is
rounded; float32 runs on the CUDA cores. The model's attention runs kernel
C; H is the stand-alone function. The backward is JAX's (`_bwd`): the vjp of the plain
version, recomputed, with no gradient for the fixed projection.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .grad import plain_vjp

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def linear_attention_plain(q, k, v, projection, kernel_eps: float = 1e-3):
    """The kernel's math in plain PyTorch, float32 from the given values."""
    proj = projection.float()
    phi_k = torch.relu(k.float() @ proj.T) + kernel_eps    # (P, L, m)
    ctx = phi_k.transpose(1, 2) @ v.float()                 # (P, m, dh)
    ksum = phi_k.sum(1)                                     # (P, m)
    phi_q = torch.relu(q.float() @ proj.T) + kernel_eps
    den = (phi_q @ ksum[..., None]).clamp_min(1e-12)        # (P, L, 1)
    return ((phi_q @ ctx) / den).to(q.dtype)


def _check(q, k, v, projection):
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (P, L, dh) shape: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if projection.ndim != 2 or projection.shape[1] != q.shape[2]:
        raise ValueError(f"projection must be (m, {q.shape[2]}): {tuple(projection.shape)}")
    if not all(t.is_floating_point() for t in (q, k, v, projection)):
        raise TypeError("linear attention takes floating-point inputs")
    if len({t.device for t in (q, k, v, projection)}) != 1:
        raise ValueError("all operands must be on one device")


def _launch(q, k, v, projection, kernel_eps):
    global launches
    P, L, dh = q.shape
    m = projection.shape[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, projection)):
        raise TypeError(f"the kernel takes q, k, v, projection of one dtype, float32 or "
                        f"bfloat16: {q.dtype} {k.dtype} {v.dtype} {projection.dtype}")
    if dh != 64 or m % 64 or not 0 < m <= 320:
        raise ValueError(f"the kernel takes dh = 64 and m % 64 == 0, m <= 320: dh={dh} m={m}")
    ts = tuple(t.contiguous() for t in (q, k, v, projection))
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel needs 16-byte aligned operands")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if P * L == 0:
        return out
    lib = build.load("linear_attention")
    fn = lib.linear_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(*(build.ptr(t) for t in ts), build.ptr(out), P, L, dh, m, float(kernel_eps),
            _DTYPES[q.dtype], build.stream_of(q))
    build.check(lib, rc, "linear_attention_fwd")
    launches += 1
    return out


def _forward(q, k, v, projection, kernel_eps):
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, projection, kernel_eps)
    if q.device.type == "cuda":
        return _launch(q, k, v, projection, kernel_eps)
    raise ValueError(f"unsupported device {q.device}")


class _LinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, projection, kernel_eps):
        ctx.save_for_backward(q, k, v, projection)
        ctx.kernel_eps = kernel_eps
        return _forward(q, k, v, projection, kernel_eps)

    @staticmethod
    def backward(ctx, g):
        q, k, v, projection = ctx.saved_tensors
        dq, dk, dv = plain_vjp(
            lambda q_, k_, v_: linear_attention_plain(q_, k_, v_, projection, ctx.kernel_eps),
            (q, k, v), g)
        return dq, dk, dv, None, None


def generalized_linear_attention(q, k, v, projection, kernel_eps: float = 1e-3):
    """ReLU-kernel FAVOR+ attention over P independent problems, differentiable
    in q, k, v: the kernel on CUDA tensors, the plain version on CPU ones;
    without grad mode the forward alone, outside autograd."""
    _check(q, k, v, projection)
    if not torch.is_grad_enabled():
        return _forward(q, k, v, projection, kernel_eps)
    return _LinearAttention.apply(q, k, v, projection, kernel_eps)
