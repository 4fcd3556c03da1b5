"""Fused generalized-FAVOR+ attention layer (kernel C): wrapper of
csrc/fused_performer.cu and its plain PyTorch version.

Port of rosettafold_tpu/ops/pallas/fused_performer.py, forward only, with the
JAX functions' names, argument order and weight layout:
  fused_ln_performer_residual(x (R, L, D), gamma, beta, wq, wk, wv, wo, bo,
      projection, scale, kernel_eps, heads, dim_head, ln_eps)
      = x + Attn(LayerNorm(x)), attending over L;
  fused_ln_performer_residual_axis1(x (B, L1, L2, D), ...): over axis 1;
  fused_performer_layer(_axis1)(x, wq, wk, wv, wo, bo, projection, scale,
      kernel_eps, heads, dim_head) = Attn(x), no LN and no residual.
wq, wk, wv (D, heads*dim_head), wo (heads*dim_head, D) and bo (D,) in x's
dtype (float32 or bfloat16); gamma, beta float32; projection (m, dim_head).
The kernel reads both axes in place through strides; `launches` counts calls
of these functions (each is three CUDA launches: projection, FAVOR+, output).
"""

from __future__ import annotations

import ctypes

import torch

from ...models.layers import layer_norm
from . import build

launches = 0  # kernel calls made by this process

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _layer_math(y, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head):
    """JAX `_layer_math` on (R, L, D) rows of the compute dtype: q, k, v,
    phi_q, phi_k, ctx and att rounded to it, float32 products; returns the
    float32 att.Wo + bo."""
    cdt = y.dtype
    R, L, _ = y.shape
    mm = lambda a, b: a.float() @ b.float()  # noqa: E731

    def split(t):  # (R, L, h*dh) -> (R, h, L, dh)
        return t.reshape(R, L, heads, dim_head).transpose(1, 2)

    q = split((mm(y, wq) * scale).to(cdt))
    k = split((mm(y, wk) * scale).to(cdt))
    v = split(mm(y, wv).to(cdt))
    p_t = projection.to(cdt).float().t()
    phi_q = (torch.relu(q.float() @ p_t) + kernel_eps).to(cdt)
    phi_k = (torch.relu(k.float() @ p_t) + kernel_eps).to(cdt)
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    ctx = mm(phi_k.transpose(-1, -2), v_ext).to(cdt)  # (R, h, m, dh + 1)
    num = mm(phi_q, ctx)
    att = num[..., :dim_head] / torch.clamp_min(num[..., dim_head:], 1e-12)
    att = att.transpose(1, 2).reshape(R, L, heads * dim_head).to(cdt)
    return mm(att, wo) + bo.float()


def performer_plain(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads,
                    dim_head, axis):
    """The kernel's math: `ln` = (gamma, beta, eps) for x + Attn(LN(x)), None
    for Attn(x); attends over `axis` (1 or 2) of a 4D x, or axis 1 of (R, L, D)."""
    xr = x.transpose(1, 2) if x.dim() == 4 and axis == 1 else x
    shape = xr.shape
    x3 = xr.reshape(-1, shape[-2], shape[-1])
    y = x3 if ln is None else layer_norm(x3, *ln).to(x.dtype)
    out = _layer_math(y, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head)
    if ln is not None:
        out = x3.float() + out
    out = out.to(x.dtype).reshape(shape)
    return out.transpose(1, 2) if x.dim() == 4 and axis == 1 else out


def _check(x, weights, ln, projection, heads, dim_head):
    wq, wk, wv, wo, bo = weights
    D, hd = x.shape[-1], heads * dim_head
    if any(w.shape != (D, hd) for w in (wq, wk, wv)) or wo.shape != (hd, D) \
            or bo.shape != (D,) or projection.dim() != 2 or projection.shape[1] != dim_head:
        raise ValueError(f"shapes: x {tuple(x.shape)} wq {tuple(wq.shape)} wo {tuple(wo.shape)} "
                         f"bo {tuple(bo.shape)} projection {tuple(projection.shape)}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in weights):
        raise TypeError("x and the weights must share float32 or bfloat16")
    ops = [x, *weights, projection]
    if ln is not None:
        if ln[0].shape != (D,) or ln[1].shape != (D,):
            raise ValueError("gamma, beta must be (D,)")
        if ln[0].dtype != torch.float32 or ln[1].dtype != torch.float32:
            raise TypeError("gamma, beta must be float32")
        ops += list(ln[:2])
    if len({t.device for t in ops}) != 1:
        raise ValueError("all operands must be on one device")


def _launch(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, axis):
    global launches
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("FAVOR+ kernel needs a contiguous, 16-byte aligned x")
    D = x.shape[-1]
    m = projection.shape[0]
    if (D, heads, dim_head, m) != (288, 8, 64, 320):
        raise ValueError("FAVOR+ kernel takes D = 288, 8 heads of 64, 320 features: "
                         f"D={D} heads={heads} dim_head={dim_head} m={m}")
    B, L1, L2 = x.shape[:3] if x.dim() == 4 else (1, *x.shape[:2])
    if axis == 1:
        P, L, p_inner, s_lo, s_pos = B * L2, L1, L2, D, L2 * D
    else:
        P, L, p_inner, s_lo, s_pos = B * L1, L2, L1, L2 * D, D
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if P > 65535:
        raise ValueError(f"{P} row-problems exceed the kernel grid")
    lib = build.load("fused_performer")
    cdt = x.dtype
    wqk, wkk, wvk, wok = (w.t().contiguous() for w in (wq, wk, wv, wo))  # nn.Linear layout
    proj = projection.to(cdt).contiguous()
    bo32 = bo.float().contiguous()
    qkv = torch.empty((P * L, 3 * heads * dim_head), dtype=cdt, device=x.device)
    att = torch.empty((P * L, heads * dim_head), dtype=cdt, device=x.device)
    if ln is not None:
        gamma, beta = ln[0].contiguous(), ln[1].contiguous()
        g_ptr, b_ptr, ln_eps = build.ptr(gamma), build.ptr(beta), float(ln[2])
    else:
        g_ptr = b_ptr = None
        ln_eps = 0.0
    fn = lib.fused_performer_fwd
    fn.restype = ctypes.c_int
    c_p, c_f, c_i, c_ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([c_p, c_p, c_p, c_f] + [c_p] * 6 + [c_f, c_f] + [c_p] * 3
                   + [c_ll, c_i, c_ll, c_ll, c_ll] + [c_i] * 6 + [c_p])
    rc = fn(build.ptr(x), g_ptr, b_ptr, ln_eps, build.ptr(wqk), build.ptr(wkk), build.ptr(wvk),
            build.ptr(wok), build.ptr(bo32), build.ptr(proj), float(scale), float(kernel_eps),
            build.ptr(qkv), build.ptr(att), build.ptr(out), P, L, L1 * L2 * D, s_lo, s_pos,
            p_inner, D, heads, dim_head, m, _DTYPES[cdt], build.stream_of(x))
    build.check(lib, rc, "fused_performer_fwd")
    launches += 1
    return out


def _run(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, axis):
    _check(x, (wq, wk, wv, wo, bo), ln, projection, heads, dim_head)
    args = (x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, axis)
    if x.device.type == "cpu":
        return performer_plain(*args)
    if x.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {x.device}")


def fused_ln_performer_residual(x, gamma, beta, wq, wk, wv, wo, bo, projection, scale,
                                kernel_eps, heads, dim_head, ln_eps):
    """x (R, L, D) + Attn(LayerNorm(x)) over L."""
    if x.dim() != 3:
        raise ValueError(f"x must be (R, L, D): {tuple(x.shape)}")
    return _run(x, (gamma, beta, ln_eps), wq, wk, wv, wo, bo, projection, scale, kernel_eps,
                heads, dim_head, 2)


def fused_ln_performer_residual_axis1(x, gamma, beta, wq, wk, wv, wo, bo, projection, scale,
                                      kernel_eps, heads, dim_head, ln_eps):
    """x (B, L1, L2, D) + Attn(LayerNorm(x)) over axis 1, read in place."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L1, L2, D): {tuple(x.shape)}")
    return _run(x, (gamma, beta, ln_eps), wq, wk, wv, wo, bo, projection, scale, kernel_eps,
                heads, dim_head, 1)


def fused_performer_layer(x, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads,
                          dim_head):
    """Attn(x) over L of x (R, L, D): no LN, no residual."""
    if x.dim() != 3:
        raise ValueError(f"x must be (R, L, D): {tuple(x.shape)}")
    return _run(x, None, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, 2)


def fused_performer_layer_axis1(x, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads,
                                dim_head):
    """Attn(x) over axis 1 of x (B, L1, L2, D), read in place."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L1, L2, D): {tuple(x.shape)}")
    return _run(x, None, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, 1)
