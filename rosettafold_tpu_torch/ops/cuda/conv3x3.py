"""Fused 3x3 dilated SAME convolution, NHWC (kernel F): wrapper of
csrc/conv3x3.cu, its plain PyTorch version and its backward.

Port of rosettafold_tpu/ops/pallas/conv3x3.py: x (B, H, W, C), w (3, 3, C,
Co) HWIO in the JAX function's layout, in x's dtype or float32 (the model's
float32 weights beside a bf16 x, as JAX passes them; the weight is cast to
x's dtype for the products), pre None or (inv, shift), each (B, C) float32:
the pre-op elu(x * inv + shift) applied to x before the conv. Out (B, H, W,
Co) in `out_dtype`: x's dtype or float32. float32 and bfloat16; float32
accumulation. `conv3x3_fused` is differentiable with JAX's backward
(`_bwd_rule`): dx is kernel F itself on the cotangent (in x's dtype) with
flipped, transposed weights and float32 output (counted in `bwd_launches`),
dw nine products of the shifted activations with the cotangent summed in
float32 and returned in w's dtype, and the pre-op's cotangent goes through
autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

launches = 0  # forward launches made by this process
bwd_launches = 0  # input-gradient launches (the backward's dx) made by this process

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
        x = _pre_op(x, *pre)
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
    if x.dtype not in _DTYPES or w.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"x float32 or bfloat16, w x's dtype or float32: {x.dtype} {w.dtype}")
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


def _launch(x, w, pre, dilation, out_dtype, bwd):
    global launches, bwd_launches
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"conv kernel writes x's dtype or float32, not {out_dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv kernel needs a contiguous, 16-byte aligned x")
    B, H, W, C = x.shape
    Co = w.shape[-1]
    if Co != 288 or C % 96:
        raise ValueError(f"conv kernel takes Co = 288 and C % 96 == 0: C={C} Co={Co}")
    out = torch.empty((B, H, W, Co), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("conv3x3")
    wk = w.to(x.dtype).permute(0, 1, 3, 2).contiguous()  # (3, 3, Co, C): [tap][co][ci]
    pre_arr = None if pre is None else torch.stack(pre, 1).contiguous()  # (B, 2, C)
    # bf16 with the pre-op: the kernel's first launch writes the activated input here
    act = torch.empty_like(x) if pre is not None and x.dtype == torch.bfloat16 else None
    fn = lib.conv3x3_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = fn(build.ptr(x), build.ptr(wk),
            None if pre_arr is None else build.ptr(pre_arr),
            None if act is None else build.ptr(act), build.ptr(out),
            B, H, W, C, Co, int(dilation), _DTYPES[x.dtype], int(out_dtype == torch.float32),
            build.stream_of(x))
    build.check(lib, rc, "conv3x3_fwd")
    if bwd:
        bwd_launches += 1
    else:
        launches += 1
    return out


def _conv(x, w, pre, dilation, out_dtype, bwd=False):
    """The kernel on a CUDA tensor, the plain version on a CPU one; `bwd`
    counts the launch as the backward's input gradient."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, pre, dilation, out_dtype)
    if x.device.type == "cuda":
        return _launch(x, w, pre, dilation, out_dtype, bwd)
    raise ValueError(f"unsupported device {x.device}")


def _pre_op(x, inv, shift):
    return F.elu(x.float() * inv[:, None, None, :] + shift[:, None, None, :]).to(x.dtype)


def conv3x3_input_grad(g, w, dilation, dtype=None):
    """dx of the conv without pre-op, float32: the conv of the cotangent
    rounded to `dtype` (the forward's x dtype; default w's) with
    flip(w, (0, 1)).swapaxes(2, 3) in that dtype."""
    dtype = dtype or w.dtype
    w_t = torch.flip(w, (0, 1)).transpose(2, 3).to(dtype)
    gc = g.to(dtype).contiguous()
    _check(gc, w_t, None, dilation)
    return _conv(gc, w_t, None, dilation, torch.float32, bwd=True)


def _product_f32(a, b):
    """a @ b of two matrices of one dtype, summed and returned in float32:
    on the card cuBLAS's bf16 product with a float32 output, on the CPU (no
    such kernel) the same products of the float32 upcasts."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def conv3x3_weight_grad(a, g, dilation):
    """dw (3, 3, C, Co) float32: per tap, the L^2 contraction of the shifted
    activations with the cotangent (in a's dtype), summed in float32 (JAX's
    dw, `preferred_element_type=f32`)."""
    d, C, Co = dilation, a.shape[-1], g.shape[-1]
    g2 = g.to(a.dtype).reshape(-1, Co)
    taps = [_product_f32(_shift2d(a, (ki - 1) * d, (kj - 1) * d).reshape(-1, C).t(), g2)
            for ki in range(3) for kj in range(3)]
    return torch.stack(taps).reshape(3, 3, C, Co)


def conv3x3_backward(x, w, pre, dilation, g):
    """JAX `_bwd_rule`: (dx, dw, dpre) with dpre None or (dinv, dshift); dw
    in w's dtype."""
    if pre is None:
        dx = conv3x3_input_grad(g, w, dilation, x.dtype).to(x.dtype)
        return dx, conv3x3_weight_grad(x, g, dilation).to(w.dtype), None
    with torch.enable_grad():
        xr, inv, shift = (t.detach().requires_grad_() for t in (x, *pre))
        a = _pre_op(xr, inv, shift)
    da = conv3x3_input_grad(g, w, dilation, x.dtype)
    dw = conv3x3_weight_grad(a.detach(), g, dilation).to(w.dtype)
    dx, dinv, dshift = torch.autograd.grad(a, (xr, inv, shift), da.to(a.dtype))
    return dx, dw, (dinv, dshift)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, inv, shift, dilation, out_dtype):
        pre = None if inv is None else (inv, shift)
        out = _conv(x, w, pre, dilation, out_dtype)
        ctx.save_for_backward(x, w, inv, shift)
        ctx.dilation = dilation
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, inv, shift = ctx.saved_tensors
        pre = None if inv is None else (inv, shift)
        dx, dw, dpre = conv3x3_backward(x, w, pre, ctx.dilation, g)
        dinv, dshift = (None, None) if dpre is None else dpre
        return dx, dw, dinv, dshift, None, None


def conv3x3_fused(x, w, pre=None, dilation=1, out_dtype=None):
    """3x3 dilated SAME conv with the optional pre-op, differentiable: the
    kernel on a CUDA tensor, the plain version on a CPU one; without grad
    mode the forward alone, outside autograd."""
    out_dtype = out_dtype or x.dtype
    _check(x, w, pre, dilation)
    if not torch.is_grad_enabled():
        return _conv(x, w, pre, int(dilation), out_dtype)
    inv, shift = (None, None) if pre is None else pre
    return _Conv3x3.apply(x, w, inv, shift, int(dilation), out_dtype)
