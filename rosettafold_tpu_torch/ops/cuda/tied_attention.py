"""Tied row attention: kernel A (forward, csrc/tied_attention.cu) and kernel G
(backward, csrc/tied_attention_bwd.cu), their wrappers and plain PyTorch
versions.

Port of rosettafold_tpu/ops/pallas/tied_attention.py: q, k (BH, L, ND); v
(BH, L, NDv) -> out (BH, L, NDv) in the input dtype, lse (BH, L) float32.
float32 and bfloat16 inputs; float32 accumulation. `tied_flash_attention` is
differentiable: its backward is G from the saved (q, k, v, out, lse), as
JAX's custom VJP. `launches` counts A, `bwd_launches` counts G (each call
three CUDA launches: dsum, then in bfloat16 p / ds and dk / dv / dq, in
float32 dk / dv and dq).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # kernel A launches made by this process
bwd_launches = 0  # kernel G launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# G's bf16 scratch (p and ds as bf16 high parts and remainders, 8 L^2 bytes a
# (b, head)) is held to this size: larger B*H*L^2 runs over chunks of B*H
BWD_SCRATCH_BYTES = 256 << 20


def _check(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 3):
        raise ValueError(f"q, k, v must be (BH, L, ND): {q.shape} {k.shape} {v.shape}")
    if q.shape != k.shape or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16: {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def tied_attention_plain(q, k, v):
    """The kernel's math in plain PyTorch: float32 logits and softmax
    statistics, probabilities rounded to v's dtype before P.V."""
    s = torch.einsum("bie,bje->bij", q.float(), k.float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bij,bjd->bid", p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


_forward = None  # the forward's C function, its argument types set once


def _forward_fn():
    global _forward
    if _forward is None:
        fn = build.load("tied_attention").tied_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _forward = fn
    return _forward


def _launch(q, k, v):
    global launches
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("tied attention kernel needs contiguous q, k, v")
    BH, L, ND = q.shape
    NDv = v.shape[-1]
    if BH > 65535:
        raise ValueError(f"BH={BH} exceeds the kernel grid")
    if ND == 0 or NDv == 0:
        raise ValueError(f"empty feature axis: ND={ND} NDv={NDv}")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (ND % 8 or NDv % 8 or (qp | kp | vp) % 16):
        raise ValueError(f"bf16 tied attention kernel needs ND, NDv % 8 == 0 and 16-byte "
                         f"aligned q, k, v: ND={ND} NDv={NDv}")
    fn = _forward_fn()
    out = torch.empty((BH, L, NDv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, L), dtype=torch.float32, device=q.device)
    if L == 0:
        return out, lse
    # bf16 in two launches (all but L <= 128, 64 < NDv <= 256): float32 scratch
    # for the logits (rows padded to 16 bytes) and the softmax statistics of
    # each 64-key tile
    scratch = None
    if bf16 and not (L <= 128 and 64 < NDv <= 256):
        scratch = torch.empty(BH * L * (-(-L // 4) * 4 + 2 * -(-L // 64)),
                              dtype=torch.float32, device=q.device)
    rc = fn(qp, kp, vp, out.data_ptr(), lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(), BH, L, ND, NDv, _DTYPES[q.dtype],
            build.stream_of(q))
    if rc:
        build.check(build.load("tied_attention"), rc, "tied_attention_fwd")
    launches += 1
    return out, lse


def tied_attention_forward(q, k, v):
    """(out, lse): the kernel on a CUDA tensor, the plain version on a CPU one."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return tied_attention_plain(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v)
    raise ValueError(f"unsupported device {q.device}")


def tied_attention_bwd_plain(q, k, v, out, lse, g):
    """JAX `_bwd` in plain PyTorch: dsum = sum(g * out) and p = exp(s - lse)
    in float32, ds = p (g v^T - dsum); dq from ds rounded to k's dtype, dk
    and dv from the float32 p and ds. Returns (dq, dk, dv)."""
    f = torch.float32
    dsum = (g.to(f) * out.to(f)).sum(-1, keepdim=True)
    p = torch.exp(torch.einsum("bie,bje->bij", q.to(f), k.to(f)) - lse[..., None])
    ds = p * (torch.einsum("bic,bjc->bij", g.to(f), v.to(f)) - dsum)
    dv = torch.einsum("bij,bic->bjc", p, g.to(f))
    dk = torch.einsum("bij,bie->bje", ds, q.to(f))
    dq = torch.einsum("bij,bje->bie", ds.to(k.dtype).to(f), k.to(f))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(v.dtype)


def _ceil_to(x, m):
    return -(-x // m) * m


_backward = None  # the backward's C function, its argument types set once


def _backward_fn():
    global _backward
    if _backward is None:
        fn = build.load("tied_attention_bwd").tied_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _backward = fn
    return _backward


def _launch_bwd(q, k, v, out, lse, g):
    global bwd_launches
    BH, L, ND = q.shape
    NDv = v.shape[-1]
    if ND % 8 or NDv % 8:
        raise ValueError(f"tied attention backward kernel needs ND, NDv % 8 == 0: {ND} {NDv}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, g)):
        raise ValueError("tied attention backward kernel needs 16-byte aligned operands")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if L == 0:
        return dq, dk, dv
    lib = build.load("tied_attention_bwd")
    dsum = torch.empty((BH, L), dtype=torch.float32, device=q.device)
    bh_chunk, scratch = 0, None
    if q.dtype == torch.bfloat16:
        per_bh = 4 * L * _ceil_to(L, 8)  # bf16 values a (b, head)
        bh_chunk = max(1, min(BH, BWD_SCRATCH_BYTES // (2 * per_bh)))
        scratch = torch.empty(bh_chunk * per_bh, dtype=torch.bfloat16, device=q.device)
    fn = _backward_fn()
    rc = fn(*(build.ptr(t) for t in (q, k, v, out, lse, g, dsum)),
            None if scratch is None else scratch.data_ptr(), bh_chunk,
            *(build.ptr(t) for t in (dq, dk, dv)), BH, L, ND, NDv, _DTYPES[q.dtype],
            build.stream_of(q))
    build.check(lib, rc, "tied_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def tied_attention_backward(q, k, v, out, lse, g):
    """(dq, dk, dv): kernel G on CUDA tensors, the plain version on CPU ones."""
    g = g.to(out.dtype).contiguous()
    if q.device.type == "cpu":
        return tied_attention_bwd_plain(q, k, v, out, lse, g)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse.contiguous(), g)
    raise ValueError(f"unsupported device {q.device}")


class _TiedFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = tied_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return tied_attention_backward(*ctx.saved_tensors, g)


def tied_flash_attention(q, k, v):
    """softmax(q @ k^T over the last axis) @ v: (BH, L, NDv), differentiable;
    without grad mode the forward alone, outside autograd."""
    if torch.is_grad_enabled():
        return _TiedFlashAttention.apply(q, k, v)
    return tied_attention_forward(q, k, v)[0]
