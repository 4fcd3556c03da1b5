"""Fused outer-product mean (kernel E): wrapper of csrc/outer_product.cu and
its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/outer_product.py, forward only:
x (i side, float32) and y (j side) are (B, N, L, u); gamma, beta (u*u,)
float32; w (u*u, Dp) in y's dtype (the JAX function's layout); b (Dp,)
float32. Returns LayerNorm(sum_n x_i (x) y_j) . w + b as (B, L, L, Dp) in
`out_dtype`, which must be y's dtype on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0  # kernel launches made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def outer_product_plain(x, y, gamma, beta, w, b, eps, out_dtype):
    """The kernel's math with its rounding points: x rounded to y's dtype,
    float32 products and two-pass LN statistics, the LN output rounded to
    y's dtype, float32 projection."""
    cdt = y.dtype
    B, N, L, u = x.shape
    op = torch.einsum("bniu,bnjv->bijuv", x.to(cdt).float(), y.float()).reshape(B, L, L, u * u)
    mu = op.mean(-1, keepdim=True)
    var = ((op - mu) ** 2).mean(-1, keepdim=True)
    ln = (op - mu) * torch.rsqrt(var + eps) * gamma + beta
    return (ln.to(cdt).float() @ w.float() + b).to(out_dtype)


def _check(x, y, gamma, beta, w, b):
    B, N, L, u = x.shape
    if y.shape != x.shape or gamma.shape != (u * u,) or beta.shape != (u * u,) \
            or w.dim() != 2 or w.shape[0] != u * u or b.shape != (w.shape[1],):
        raise ValueError(f"shapes: x {tuple(x.shape)} y {tuple(y.shape)} w {tuple(w.shape)} "
                         f"b {tuple(b.shape)}")
    if x.dtype != torch.float32 or y.dtype not in _DTYPES or w.dtype != y.dtype:
        raise TypeError(f"x float32, y and w float32 or bfloat16: {x.dtype} {y.dtype} {w.dtype}")
    if any(t.dtype != torch.float32 for t in (gamma, beta, b)):
        raise TypeError("gamma, beta, b must be float32")
    if len({t.device for t in (x, y, gamma, beta, w, b)}) != 1:
        raise ValueError("all operands must be on one device")


def _launch(x, y, gamma, beta, w, b, eps, out_dtype):
    global launches
    if out_dtype != y.dtype:
        raise TypeError(f"outer-product kernel writes y's dtype: {out_dtype} != {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("outer-product kernel needs contiguous x, y")
    B, N, L, u = x.shape
    Dp = w.shape[1]
    if u != 32 or Dp != 288:
        raise ValueError(f"outer-product kernel takes u = 32 and Dp = 288: u={u} Dp={Dp}")
    out = torch.empty((B, L, L, Dp), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    lib = build.load("outer_product")
    wt = w.t().contiguous()  # (Dp, u*u): nn.Linear layout
    g, be, bb = (t.contiguous() for t in (gamma, beta, b))
    fn = lib.outer_product_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(build.ptr(x), build.ptr(y), build.ptr(g), build.ptr(be), build.ptr(wt),
            build.ptr(bb), build.ptr(out), B, N, L, u, Dp, float(eps), _DTYPES[y.dtype],
            build.stream_of(y))
    build.check(lib, rc, "outer_product_fwd")
    launches += 1
    return out


def fused_outer_product_mean(x, y, gamma, beta, w, b, eps=1e-5, out_dtype=None):
    """The fused OPM: the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    out_dtype = out_dtype or y.dtype
    _check(x, y, gamma, beta, w, b)
    if y.device.type == "cpu":
        return outer_product_plain(x, y, gamma, beta, w, b, eps, out_dtype)
    if y.device.type == "cuda":
        return _launch(x, y, gamma, beta, w, b, eps, out_dtype)
    raise ValueError(f"unsupported device {y.device}")
