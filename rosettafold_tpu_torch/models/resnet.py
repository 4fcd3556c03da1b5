"""2D dilated-conv ResNet on NHWC tensors (port of rosettafold_tpu/models/resnet.py).
InstanceNorm: eps 1e-6, biased variance, float32 statistics.
With conv_impl="pallas" the 3x3 convs of a block run as kernel F
(ops/cuda/conv3x3.py) from `fused_min_l` (default 128, as JAX).

On the kernel path outside autograd, on a CUDA tensor, the InstanceNorm
statistics and the affine + ELU epilogues (of the blocks and of the ResNet's
input norm) run as kernel IN (ops/cuda/instance_norm.py); `takes_kernel` is
the one decision.

`row_chunk` is the long-L inference mode (JAX's `row_chunk`): above that many
rows, every full-tensor float32 pass runs over row chunks into one output
buffer, so its temporaries are O(chunk * L * C). On the kernel path F runs
on the whole tensor and only the plain residual + ELU epilogue is chunked
(kernel IN holds no float32 temporary, so it takes the whole map); on the
plain path the convolutions run chunk by chunk too, each reading a halo of
`dilation` rows, with InstanceNorm statistics taken over the whole raw conv
output. The result equals the unchunked one."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import instance_norm as in_kernel
from ..ops.cuda.conv3x3 import conv3x3_fused
from .layers import FUSED_MIN_L, ConvNHWC

# InstanceNorm decisions on the kernel path that autograd or active dropout kept
# on the plain version (a CPU tensor takes the plain version uncounted)
plain_calls = 0


class InstanceNorm2d(nn.Module):
    """InstanceNorm over the spatial axes of NHWC, affine, biased variance,
    float32 statistics and output."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def instance_stats(y, weight, bias, eps):
    """InstanceNorm of y as the affine pair (inv, shift), each (B, C) float32:
    IN(y) = y * inv + shift (JAX `_InStats(return_affine=True)`)."""
    yf = y.float()
    mean = yf.mean(dim=(1, 2))
    var = yf.var(dim=(1, 2), unbiased=False)
    inv = weight / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def takes_kernel(*tensors) -> bool:
    """Whether an InstanceNorm call of the kernel path runs as kernel IN: its
    first tensor on the card and autograd recording none of them. A call that
    autograd keeps on the plain version is counted in `plain_calls`."""
    global plain_calls
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        plain_calls += 1
        return False
    return tensors[0].is_cuda


def kernel_stats(y, norm: InstanceNorm2d):
    """The kernel path's `instance_stats` with norm's parameters: kernel IN
    where `takes_kernel`."""
    if takes_kernel(y, norm.weight, norm.bias):
        return in_kernel.instance_affine(y, norm.weight, norm.bias, norm.eps)
    return instance_stats(y, norm.weight, norm.bias, norm.eps)


def chunks(H: int, row_chunk):
    """Row ranges [i0, i1) of the row-chunked mode; one range without it."""
    c = row_chunk if row_chunk is not None and H > row_chunk else H
    return [(i0, min(i0 + c, H)) for i0 in range(0, H, c)]


def conv_rows(conv: ConvNHWC, x, dilation: int, row_chunk: int, pre=None):
    """conv(pre(x)) (SAME 3x3, dilated) row chunk by row chunk: each chunk
    reads a halo of `dilation` rows; `pre` (elementwise, its result cast to
    x's dtype) is applied to each chunk's read. Equals the whole conv."""
    H = x.shape[1]
    out = None
    for i0, i1 in chunks(H, row_chunk):
        lo, hi = max(0, i0 - dilation), min(H, i1 + dilation)
        xs = x[:, lo:hi]
        if pre is not None:
            xs = pre(xs).to(x.dtype)
        y = conv(xs)[:, i0 - lo:i1 - lo]
        if out is None:
            out = y.new_empty((y.shape[0], H, *y.shape[2:]))
        out[:, i0:i1] = y
    return out


def affine_elu_rows(y, inv, shift, out_dtype, row_chunk, x=None):
    """elu([x +] y * inv + shift) in float32, per-channel (B, C) affine, cast to
    out_dtype; over row chunks into one buffer above row_chunk rows."""
    def f(i0, i1):
        t = y[:, i0:i1].float() * inv[:, None, None, :]
        if x is not None:
            t = x[:, i0:i1].float() + t
        return F.elu(t + shift[:, None, None, :]).to(out_dtype)

    ranges = chunks(y.shape[1], row_chunk)
    if len(ranges) == 1:
        return f(0, y.shape[1])
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    for i0, i1 in ranges:
        out[:, i0:i1] = f(i0, i1)
    return out


def kernel_affine_elu(y, inv, shift, out_dtype, row_chunk, x=None):
    """The kernel path's `affine_elu_rows`: kernel IN, on the whole map, where
    `takes_kernel`."""
    if takes_kernel(y, inv, shift, x):
        return in_kernel.instance_apply(y, inv, shift, x, out_dtype)
    return affine_elu_rows(y, inv, shift, out_dtype, row_chunk, x)


def hwio(conv: ConvNHWC):
    """The conv's float32 weight in the JAX layout (kh, kw, C_in, C_out);
    kernel F casts it to the activations' dtype for the products and keeps
    its gradient in float32, as JAX's kernel path does."""
    return conv.weight.permute(2, 3, 1, 0)


def conv_block_kernels(block, x, dilation: int, row_chunk=None):
    """The residual conv block on kernel F, in JAX's kernel-path form: conv ->
    IN statistics as (inv, shift) -> conv with the IN affine + ELU as its
    pre-op (or, under active dropout, applied before it, plain) -> elu(x + y2
    * inv2 + shift2). The statistics and that last step run as kernel IN where
    `takes_kernel`; the plain last step is row-chunked above row_chunk rows.
    `block` holds conv1, conv2, in1, in2, dropout and dtype. JAX's row tiling can refuse
    some L (`pick_tile` returns None) and falls back to the XLA conv there;
    kernel F takes every L, with the same result."""
    global plain_calls
    ct = block.dtype or torch.float32
    x = x.to(ct).contiguous()
    y1 = conv3x3_fused(x, hwio(block.conv1), None, dilation, ct)
    inv1, shift1 = kernel_stats(y1, block.in1)
    if block.training and block.dropout.p > 0:
        plain_calls += 1
        a = F.elu(y1.float() * inv1[:, None, None, :] + shift1[:, None, None, :])
        y2 = conv3x3_fused(block.dropout(a).to(ct), hwio(block.conv2), None, dilation, ct)
    else:
        y2 = conv3x3_fused(y1, hwio(block.conv2), (inv1, shift1), dilation, ct)
    inv2, shift2 = kernel_stats(y2, block.in2)
    return kernel_affine_elu(y2, inv2, shift2, ct, row_chunk, x)


def conv_block_rows(block, x, dilation: int, row_chunk: int):
    """The plain residual conv block, row-chunked (inference): both convs
    through `conv_rows`, IN statistics over the whole raw conv outputs, the
    first IN + ELU applied in the second conv's read."""
    n1, n2 = block.in1, block.in2
    y1 = conv_rows(block.conv1, x, dilation, row_chunk)
    inv1, shift1 = instance_stats(y1, n1.weight, n1.bias, n1.eps)
    y2 = conv_rows(block.conv2, y1, dilation, row_chunk,
                   pre=lambda t: F.elu(t.float() * inv1[:, None, None, :]
                                       + shift1[:, None, None, :]))
    inv2, shift2 = instance_stats(y2, n2.weight, n2.bias, n2.eps)
    return affine_elu_rows(y2, inv2, shift2, block.dtype or torch.float32, row_chunk, x)


class ResBlock2D(nn.Module):
    """conv3x3(dilated) -> IN -> ELU -> Dropout -> conv3x3 -> IN, residual, ELU.

    With conv_impl="pallas" and H >= fused_min_l: `conv_block_kernels`;
    otherwise, with row_chunk < H outside training: `conv_block_rows`."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 p_dropout: float = 0.15, dtype=None, conv_impl: str = "xla",
                 fused_min_l: int = FUSED_MIN_L, row_chunk=None):
        super().__init__()
        self.dtype, self.conv_impl, self.row_chunk = dtype, conv_impl, row_chunk
        self.kernel_size, self.dilation, self.fused_min_l = kernel_size, dilation, fused_min_l
        self.conv1 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.conv2 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.in1 = InstanceNorm2d(channels)
        self.in2 = InstanceNorm2d(channels)
        self.dropout = nn.Dropout(p_dropout)

    def kernels(self, H: int) -> bool:
        """Whether a map of H rows takes `conv_block_kernels`."""
        return self.conv_impl == "pallas" and self.kernel_size == 3 and H >= self.fused_min_l

    def forward(self, x):
        if self.kernels(x.shape[1]):
            return conv_block_kernels(self, x, self.dilation, self.row_chunk)
        if len(chunks(x.shape[1], self.row_chunk)) > 1:
            if self.training:
                raise ValueError("the row-chunked ResBlock2D is an inference path")
            return conv_block_rows(self, x, self.dilation, self.row_chunk)
        y = self.dropout(F.elu(self.in1(self.conv1(x))))
        y = self.in2(self.conv2(y))
        out = F.elu(x.float() + y)
        return out if self.dtype is None else out.to(self.dtype)


class ResNet(nn.Module):
    """1x1 in-proj + IN + ELU; n blocks with dilations cycling (1, 2, 4, 8);
    1x1 out-proj with bias. row_chunk: see the module docstring."""

    def __init__(self, n_res_blocks: int, in_channels: int, intermediate_channels: int,
                 out_channels: int, dilations=(1, 2, 4, 8), p_dropout: float = 0.15,
                 dtype=None, conv_impl: str = "xla", row_chunk=None):
        super().__init__()
        self.dtype, self.n, self.row_chunk = dtype, n_res_blocks, row_chunk
        self.proj_in = ConvNHWC(in_channels, intermediate_channels, 1, dtype=dtype)
        self.in_in = InstanceNorm2d(intermediate_channels)
        for i in range(n_res_blocks):
            self.add_module(f"block_{i}", ResBlock2D(
                intermediate_channels, 3, dilations[i % len(dilations)], p_dropout,
                dtype=dtype, conv_impl=conv_impl, row_chunk=row_chunk))
        self.proj_out = ConvNHWC(intermediate_channels, out_channels, 1, bias=True)

    def forward(self, x):
        x = self.proj_in(x)
        ct, norm = self.dtype or torch.float32, self.in_in
        if (self.n > 0 and self.block_0.kernels(x.shape[1])
                and takes_kernel(x, norm.weight, norm.bias)):
            inv, shift = in_kernel.instance_affine(x, norm.weight, norm.bias, norm.eps)
            x = in_kernel.instance_apply(x, inv, shift, None, ct)
        elif len(chunks(x.shape[1], self.row_chunk)) > 1:
            inv, shift = instance_stats(x, norm.weight, norm.bias, norm.eps)
            x = affine_elu_rows(x, inv, shift, ct, self.row_chunk)
        else:
            x = F.elu(self.in_in(x))
            if self.dtype is not None:
                x = x.to(self.dtype)
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
        return self.proj_out(x)
