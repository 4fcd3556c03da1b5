"""Fused outer-product mean (kernel E): wrapper of csrc/outer_product.cu and
its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/outer_product.py:
x (i side, float32) and y (j side) are (B, N, L, u); gamma, beta (u*u,)
float32; w (u*u, Dp) in y's dtype (the JAX function's layout); b (Dp,)
float32. Returns LayerNorm(sum_n x_i (x) y_j) . w + b as (B, L, L, Dp) in
`out_dtype`, which must be y's dtype on the card. The backward is JAX's
(`_bwd`): the vjp of the plain version recomputed over chunks of 128 i-rows,
so one chunk's (B, 128, L, u*u) slab is alive at a time.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .grad import plain_vjp

launches = 0  # kernel launches made by this process
BWD_CHUNK = 128  # i-rows recomputed per step of the backward (JAX `_BWD_CHUNK`)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_orders: dict = {}  # device -> chunk_order() there


def chunk_order(device, u=32):
    """W's rows in the bf16 kernel's K order: its 16 chunks of 8 u x 8 v
    (chunk c = 4 (u // 8) + v // 8), each row-major in (u % 8, v % 8)."""
    if device not in _orders:
        c, ul, vl = torch.meshgrid(torch.arange(16), torch.arange(8), torch.arange(8),
                                   indexing="ij")
        _orders[device] = (u * (8 * (c // 4) + ul) + 8 * (c % 4) + vl).reshape(-1).to(device)
    return _orders[device]


def outer_product_plain(x, y, gamma, beta, w, b, eps, out_dtype):
    """The kernel's math with its rounding points: x rounded to y's dtype,
    float32 products and two-pass LN statistics, the LN output rounded to
    y's dtype, float32 projection."""
    cdt = y.dtype
    B, N, Li, u = x.shape  # x may be a cut of the i side (the backward's chunks)
    op = torch.einsum("bniu,bnjv->bijuv", x.to(cdt).float(), y.float())
    op = op.reshape(B, Li, y.shape[2], u * u)
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
    if not (x.is_contiguous() and y.is_contiguous()) or (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("outer-product kernel needs contiguous, 16-byte aligned x, y")
    B, N, L, u = x.shape
    Dp = w.shape[1]
    if u != 32 or Dp != 288:
        raise ValueError(f"outer-product kernel takes u = 32 and Dp = 288: u={u} Dp={Dp}")
    out = torch.empty((B, L, L, Dp), dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    lib = build.load("outer_product")
    wt = w.t()  # (Dp, u*u): nn.Linear layout; bf16 with K in the kernel's chunk order
    if y.dtype == torch.bfloat16:
        wt = wt.index_select(1, chunk_order(w.device, u))
    wt = wt.contiguous()
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


def _forward(*args):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    y = args[1]
    if y.device.type == "cpu":
        return outer_product_plain(*args)
    if y.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {y.device}")


class _OuterProductMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, gamma, beta, w, b, eps, out_dtype):
        ctx.save_for_backward(x, y, gamma, beta, w, b)
        ctx.statics = (eps, out_dtype)
        return _forward(x, y, gamma, beta, w, b, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        L = x.shape[2]
        dx, total = [], None
        for i0 in range(0, L, BWD_CHUNK):
            d = plain_vjp(outer_product_plain, (x[:, :, i0:i0 + BWD_CHUNK], *rest),
                          g[:, i0:i0 + BWD_CHUNK], *ctx.statics)
            dx.append(d[0])
            part = [t.float() for t in d[1:]]  # summed over chunks in float32
            total = part if total is None else [a + c for a, c in zip(total, part)]
        return (torch.cat(dx, 2), *(t.to(r.dtype) for t, r in zip(total, rest)), None, None)


def fused_outer_product_mean(x, y, gamma, beta, w, b, eps=1e-5, out_dtype=None):
    """The fused OPM, differentiable: the kernel on a CUDA tensor, the plain
    version on a CPU one; without grad mode the forward alone, outside
    autograd."""
    out_dtype = out_dtype or y.dtype
    _check(x, y, gamma, beta, w, b)
    if not torch.is_grad_enabled():
        return _forward(x, y, gamma, beta, w, b, eps, out_dtype)
    return _OuterProductMean.apply(x, y, gamma, beta, w, b, eps, out_dtype)
