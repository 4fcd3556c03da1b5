"""Backward by recomputation: the gradient of a kernel whose JAX backward is
plain XLA (`fused_ff._bwd_rule`, `outer_product._bwd`, `se3_attend._bwd_rule`)
is the vjp of the kernel's plain PyTorch version, recomputed from the saved
inputs under autograd."""

from __future__ import annotations

import torch


def plain_vjp(plain, inputs, grads_out, *static):
    """Gradients of `plain(*inputs, *static)` for the cotangents `grads_out`
    (a tensor, or a list matching the tensors `plain` returns in order). One
    entry per input: None for an input that is None or not floating point."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if isinstance(t, torch.Tensor)
                  and t.is_floating_point() else t for t in inputs]
        out = plain(*leaves, *static)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    gs = list(grads_out) if isinstance(grads_out, (list, tuple)) else [grads_out]
    wrt = [t for t in leaves if isinstance(t, torch.Tensor) and t.requires_grad]
    got = iter(torch.autograd.grad(outs, wrt, [g.to(o.dtype) for o, g in zip(outs, gs)],
                                   allow_unused=True))
    return [next(got) if isinstance(t, torch.Tensor) and t.requires_grad else None
            for t in leaves]
