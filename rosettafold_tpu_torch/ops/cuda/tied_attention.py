"""Tied row attention (kernel A): wrapper of csrc/tied_attention.cu and its
plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/tied_attention.py, forward only:
q, k (BH, L, ND); v (BH, L, NDv) -> out (BH, L, NDv) in the input dtype,
lse (BH, L) float32. float32 and bfloat16 inputs; float32 accumulation.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch(q, k, v):
    global launches
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("tied attention kernel needs contiguous q, k, v")
    BH, L, ND = q.shape
    NDv = v.shape[-1]
    if BH > 65535:
        raise ValueError(f"BH={BH} exceeds the kernel grid")
    if ND == 0 or NDv == 0:
        raise ValueError(f"empty feature axis: ND={ND} NDv={NDv}")
    lib = build.load("tied_attention")
    out = torch.empty((BH, L, NDv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, L), dtype=torch.float32, device=q.device)
    if L == 0:
        return out, lse
    fn = lib.tied_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), build.ptr(lse),
            BH, L, ND, NDv, _DTYPES[q.dtype], build.stream_of(q))
    build.check(lib, rc, "tied_attention_fwd")
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


def tied_flash_attention(q, k, v):
    """softmax(q @ k^T over the last axis) @ v: (BH, L, NDv)."""
    return tied_attention_forward(q, k, v)[0]
