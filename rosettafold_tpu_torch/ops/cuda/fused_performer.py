"""Fused generalized-FAVOR+ attention layer: kernel C (forward,
csrc/fused_performer.cu) and kernel C' (backward, csrc/fused_performer_bwd.cu),
their wrappers and plain PyTorch versions.

Port of rosettafold_tpu/ops/pallas/fused_performer.py, with the JAX
functions' names, argument order and weight layout:
  fused_ln_performer_residual(x (R, L, D), gamma, beta, wq, wk, wv, wo, bo,
      projection, scale, kernel_eps, heads, dim_head, ln_eps)
      = x + Attn(LayerNorm(x)), attending over L;
  fused_ln_performer_residual_axis1(x (B, L1, L2, D), ...): over axis 1;
  fused_performer_layer(_axis1)(x, wq, wk, wv, wo, bo, projection, scale,
      kernel_eps, heads, dim_head) = Attn(x), no LN and no residual.
wq, wk, wv (D, heads*dim_head), wo (heads*dim_head, D) and bo (D,) in x's
dtype (float32 or bfloat16); gamma, beta float32; projection (m, dim_head).
The kernels read both axes in place through strides. All four functions
are differentiable with JAX's backward: C' for the attention (no gradient
for `projection`, as JAX returns zeros), LN(x) recomputed and its cotangent
routed through autograd in the LN forms (`_bwd_rule_lnres`). `launches`
counts calls of C (three CUDA launches each: projection, FAVOR+, output),
`bwd_launches` calls of C' (five steps: projections, FAVOR+, dx,
weight-gradient partials, their sum; six CUDA launches in bf16, whose q/k/v
and go projections are two).
"""

from __future__ import annotations

import ctypes

import torch

from ...models.layers import layer_norm
from . import build

launches = 0  # kernel C calls made by this process
bwd_launches = 0  # kernel C' calls made by this process

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


_fwd = None  # kernel C's C function, its argument types set once


def _fwd_fn():
    global _fwd
    if _fwd is None:
        fn = build.load("fused_performer").fused_performer_fwd
        fn.restype = ctypes.c_int
        c_p, c_f, c_i, c_ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([c_p, c_p, c_p, c_f] + [c_p] * 6 + [c_f, c_f] + [c_p] * 3
                       + [c_ll, c_i, c_ll, c_ll, c_ll] + [c_i] * 6 + [c_p])
        _fwd = fn
    return _fwd


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
    fn = _fwd_fn()
    cdt = x.dtype
    wqk, wkk, wvk, wok = (w.t().contiguous() for w in (wq, wk, wv, wo))  # nn.Linear layout
    proj = projection.to(cdt).contiguous()
    bo32 = bo.float().contiguous()
    qkv = torch.empty((P * L, 3 * heads * dim_head), dtype=cdt, device=x.device)
    att = torch.empty((P * L, heads * dim_head), dtype=cdt, device=x.device)
    if ln is not None:
        gamma, beta = ln[0].contiguous(), ln[1].contiguous()
        g_ptr, b_ptr, ln_eps = gamma.data_ptr(), beta.data_ptr(), float(ln[2])
    else:
        g_ptr = b_ptr = None
        ln_eps = 0.0
    rc = fn(x.data_ptr(), g_ptr, b_ptr, ln_eps, wqk.data_ptr(), wkk.data_ptr(), wvk.data_ptr(),
            wok.data_ptr(), bo32.data_ptr(), proj.data_ptr(), float(scale), float(kernel_eps),
            qkv.data_ptr(), att.data_ptr(), out.data_ptr(), P, L, L1 * L2 * D, s_lo, s_pos,
            p_inner, D, heads, dim_head, m, _DTYPES[cdt], build.stream_of(x))
    if rc:
        build.check(build.load("fused_performer"), rc, "fused_performer_fwd")
    launches += 1
    return out


def performer_bwd_plain(x, gy, wq, wk, wv, wo, projection, scale, kernel_eps, heads,
                        dim_head):
    """JAX `_bwd_kernel` in plain PyTorch on (R, L, D) rows x of the compute
    dtype and the cotangent gy of Attn(x): its roundings to the compute dtype,
    the ones column folding ksum into ctx and the gden column folding g_ksum
    into g_ctx. Returns (dx, dwq, dwk, dwv, dwo, dbo), dbo float32."""
    f, cdt = torch.float32, x.dtype
    R, L, D = x.shape
    hd = heads * dim_head

    def mm(a, b):
        return a.to(f) @ b.to(f)

    def split(t):  # (R, L, h*dh) -> (R, h, L, dh)
        return t.reshape(R, L, heads, dim_head).transpose(1, 2)

    def merge(t):  # (R, h, L, dh) -> (R, L, h*dh)
        return t.transpose(1, 2).reshape(R, L, hd)

    gy = gy.to(cdt)
    q = split((mm(x, wq) * scale).to(cdt))
    k = split((mm(x, wk) * scale).to(cdt))
    v = split(mm(x, wv).to(cdt))
    go = split(mm(gy, wo.t()))
    proj = projection.to(cdt)
    sq, sk = mm(q, proj.t()), mm(k, proj.t())
    phi_q = (torch.relu(sq) + kernel_eps).to(cdt)
    phi_k = (torch.relu(sk) + kernel_eps).to(cdt)
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    ctx = mm(phi_k.transpose(-1, -2), v_ext).to(cdt)      # (R, h, m, dh + 1)
    num = mm(phi_q, ctx)
    r = 1.0 / torch.clamp_min(num[..., dim_head:], 1e-12)
    o = num[..., :dim_head] * r
    gden = -(go * o).sum(-1, keepdim=True) * r
    gnum_ext = torch.cat([go * r, gden], -1).to(cdt)
    g_pq = mm(gnum_ext, ctx.transpose(-1, -2))             # d phi_q
    g_ctx = mm(phi_q.transpose(-1, -2), gnum_ext).to(cdt)  # [d ctx | g_ksum]
    g_pk = mm(v_ext, g_ctx.transpose(-1, -2))              # d phi_k
    g_sq = (g_pq * (sq > 0)).to(cdt)
    g_sk = (g_pk * (sk > 0)).to(cdt)
    gq = (merge(mm(g_sq, proj)) * scale).to(cdt)
    gk = (merge(mm(g_sk, proj)) * scale).to(cdt)
    gv = merge(mm(phi_k, g_ctx[..., :dim_head])).to(cdt)
    att = merge(o).to(cdt)
    dx = (mm(gq, wq.t()) + mm(gk, wk.t()) + mm(gv, wv.t())).to(cdt)
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dw = [mm(rows(x).t(), rows(g)).to(w.dtype) for g, w in ((gq, wq), (gk, wk), (gv, wv))]
    dwo = mm(rows(att).t(), rows(gy)).to(wo.dtype)
    return (dx, *dw, dwo, rows(gy).to(f).sum(0))


def _as_rows(t, axis):
    """(R, L, D) rows attended over: axis 1 of a 4D t is transposed, as JAX's
    `_bwd_rule_axis1` does."""
    if t.dim() == 4 and axis == 1:
        t = t.transpose(1, 2)
    return t.reshape(-1, *t.shape[-2:])


def wgrad_splits(P, L, dtype=torch.bfloat16):
    """Split-K partials of C''s weight gradients: bf16 splits the 64-position
    row chunks of P problems into at most 8 ranges (16 output tiles x 8 fill
    the card); float32 the rows into ranges of 2048."""
    if dtype == torch.bfloat16:
        return min(8, P * -(-L // 64))
    return max(1, min(32, -(-(P * L) // 2048)))


def _launch_bwd(y, gy, wq, wk, wv, wo, projection, scale, kernel_eps, heads, dim_head, axis):
    global bwd_launches
    D = y.shape[-1]
    m = projection.shape[0]
    if (D, heads, dim_head, m) != (288, 8, 64, 320):
        raise ValueError("FAVOR+ backward kernel takes D = 288, 8 heads of 64, 320 features: "
                         f"D={D} heads={heads} dim_head={dim_head} m={m}")
    if y.data_ptr() % 16 or gy.data_ptr() % 16:
        raise ValueError("FAVOR+ backward kernel needs 16-byte aligned y, gy")
    B, L1, L2 = y.shape[:3] if y.dim() == 4 else (1, *y.shape[:2])
    if axis == 1:
        P, L, p_inner, s_lo, s_pos = B * L2, L1, L2, D, L2 * D
    else:
        P, L, p_inner, s_lo, s_pos = B * L1, L2, L1, L2 * D, D
    if P > 65535:
        raise ValueError(f"{P} row-problems exceed the kernel grid")
    lib = build.load("fused_performer_bwd")
    cdt, dev, M = y.dtype, y.device, P * L
    hd = heads * dim_head
    lib.fused_performer_bwd_wgrad_elems.restype = ctypes.c_int
    n_w = lib.fused_performer_bwd_wgrad_elems()
    splits = wgrad_splits(P, L, cdt)
    w_lin = [w.t().contiguous() for w in (wq, wk, wv)]  # nn.Linear layout
    w3 = torch.cat([wq, wk, wv], 1).contiguous()
    wo_c, proj = wo.contiguous(), projection.to(cdt).contiguous()
    qkv = torch.empty((M, 3 * hd), dtype=cdt, device=dev)
    g3 = torch.empty((M, 3 * hd), dtype=cdt, device=dev)
    att = torch.empty((M, hd), dtype=cdt, device=dev)
    go = torch.empty((M, hd), dtype=torch.float32, device=dev)
    gn = gden = None  # bf16: gnum_ext between the FAVOR+ launch's phases
    if cdt == torch.bfloat16:
        gn = torch.empty((M, hd), dtype=cdt, device=dev)
        gden = torch.empty((M, heads), dtype=torch.float32, device=dev)
    part = torch.empty((splits, n_w), dtype=torch.float32, device=dev)
    wgrad = torch.empty(n_w, dtype=torch.float32, device=dev)
    dy = torch.empty_like(y)
    fn = lib.fused_performer_bwd
    fn.restype = ctypes.c_int
    c_p, c_f, c_i, c_ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([c_p] * 8 + [c_f, c_f] + [c_p] * 8 + [c_i, c_p, c_ll, c_i, c_ll, c_ll, c_ll]
                   + [c_i] * 6 + [c_p])
    rc = fn(build.ptr(y), build.ptr(gy), *(build.ptr(w) for w in w_lin), build.ptr(wo_c),
            build.ptr(w3), build.ptr(proj), float(scale), float(kernel_eps), build.ptr(qkv),
            build.ptr(go), build.ptr(att), build.ptr(g3),
            None if gn is None else build.ptr(gn), None if gden is None else build.ptr(gden),
            build.ptr(dy), build.ptr(part),
            splits, build.ptr(wgrad), P, L, L1 * L2 * D, s_lo, s_pos, p_inner, D, heads,
            dim_head, m, _DTYPES[cdt], build.stream_of(y))
    build.check(lib, rc, "fused_performer_bwd")
    bwd_launches += 1
    n = D * hd
    dwq, dwk, dwv = (wgrad[i * n:(i + 1) * n].view(D, hd).to(w.dtype)
                     for i, w in enumerate((wq, wk, wv)))
    dwo_ext = wgrad[3 * n:].view(hd + 1, D)
    return dy, dwq, dwk, dwv, dwo_ext[:hd].to(wo.dtype), dwo_ext[hd]


def attn_backward_plain(y, gy, weights, projection, statics, axis):
    """(dy, dwq, dwk, dwv, dwo, dbo) of Attn(y), y (R, L, D) or 4D attended
    over `axis`: performer_bwd_plain on the rows."""
    wq, wk, wv, wo = weights
    dyr, *dw = performer_bwd_plain(_as_rows(y, axis), _as_rows(gy, axis), wq, wk, wv, wo,
                                   projection, *statics)
    if y.dim() == 4 and axis == 1:
        B, L1, L2, D = y.shape
        dy = dyr.reshape(B, L2, L1, D).transpose(1, 2)
    else:
        dy = dyr.reshape(y.shape)
    return (dy, *dw)


def attn_backward(y, gy, weights, projection, statics, axis):
    """attn_backward_plain's result: C' on CUDA tensors, the plain version on
    CPU ones. statics: (scale, kernel_eps, heads, dim_head)."""
    if y.device.type == "cuda":
        return _launch_bwd(y, gy, *weights, projection, *statics, axis)
    if y.device.type == "cpu":
        return attn_backward_plain(y, gy, weights, projection, statics, axis)
    raise ValueError(f"unsupported device {y.device}")


def performer_backward(x, ln, wq, wk, wv, wo, projection, scale, kernel_eps, heads, dim_head,
                       axis, gy, core=None):
    """The gradients of performer_plain's function (JAX's backward rules):
    (dx, dgamma, dbeta, dwq, dwk, dwv, dwo, dbo), dgamma and dbeta None
    without LN. `core` computes the attention's part: attn_backward (C' on
    the card) unless given."""
    core = core or attn_backward
    gy = gy.to(x.dtype).contiguous()
    statics = (scale, kernel_eps, heads, dim_head)
    if ln is None:
        dx, *dw = core(x, gy, (wq, wk, wv, wo), projection, statics, axis)
        return (dx, None, None, *dw)
    with torch.enable_grad():
        xr, gamma, beta = (t.detach().requires_grad_() for t in (x, ln[0], ln[1]))
        y = layer_norm(xr, gamma, beta, ln[2]).to(x.dtype)
    dy, *dw = core(y.detach().contiguous(), gy, (wq, wk, wv, wo), projection, statics, axis)
    dx_ln, dgamma, dbeta = torch.autograd.grad(y, (xr, gamma, beta), dy)
    return ((gy.to(dx_ln.dtype) + dx_ln).to(x.dtype), dgamma, dbeta, *dw)


def _forward(*args):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    x = args[0]
    if x.device.type == "cpu":
        return performer_plain(*args)
    if x.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {x.device}")


class _Performer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wq, wk, wv, wo, bo, projection, statics):
        """statics: (scale, kernel_eps, heads, dim_head, ln_eps, axis)."""
        scale, kernel_eps, heads, dim_head, ln_eps, axis = statics
        ln = None if gamma is None else (gamma, beta, ln_eps)
        ctx.save_for_backward(x, gamma, beta, wq, wk, wv, wo, projection)
        ctx.statics = statics
        return _forward(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads,
                        dim_head, axis)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, wq, wk, wv, wo, projection = ctx.saved_tensors
        scale, kernel_eps, heads, dim_head, ln_eps, axis = ctx.statics
        ln = None if gamma is None else (gamma, beta, ln_eps)
        grads = performer_backward(x, ln, wq, wk, wv, wo, projection, scale, kernel_eps, heads,
                                   dim_head, axis, gy)
        return (*grads, None, None)


def _run(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads, dim_head, axis):
    _check(x, (wq, wk, wv, wo, bo), ln, projection, heads, dim_head)
    if not torch.is_grad_enabled():  # the forward alone, outside autograd
        return _forward(x, ln, wq, wk, wv, wo, bo, projection, scale, kernel_eps, heads,
                        dim_head, axis)
    gamma, beta, ln_eps = (None, None, None) if ln is None else ln
    return _Performer.apply(x, gamma, beta, wq, wk, wv, wo, bo, projection,
                            (scale, kernel_eps, heads, dim_head, ln_eps, axis))


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
