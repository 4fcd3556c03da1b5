#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on a CUDA card and
check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-time   (phases 1-2 and the C and D wrappers'
                                         host time alone; no result line)

Phases (any failure exits non-zero and prints no result line):
  1. device: a CUDA card is required; prints torch/CUDA versions and
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
  2. build: compiles the kernels' CUDA sources from csrc/ (one nvcc per
     source, all at once, sm_90a), logging each kernel's registers, stack
     and spills (-Xptxas -v);
  3. kernel vs plain at the main path's shapes, TF32 off, float32 and
     bfloat16: tied attention (A) at L in {120, 128, 250} and every MSA depth
     N the serving and training phases run (PATH_NS), at a ragged L=77 with
     B*H=5 (no multiple of the bf16 kernels' tiles or of the grid), and in
     bfloat16 at the long requests' (L, N) = (512, 64) and (1100, 32)
     (LONG_PATH), those two with their times in `by_shape`;
     SE(3) attend (B) at the three GSE3Res layer shapes, B=4, L=128, kNN mask,
     and on its gather layout (`src_idx` from `knn_bucket_indices` of a
     random-walk backbone) at L=512 and L=1100 with S=272 (K_max 128) and
     S=80 (K 32), and at a ragged L=77, S=48; B's device time
     (torch.profiler) and its bound on the 3xTF32 tensor-core line beside
     the float32 one at res_1's dense and gather shapes and at L=1100 (the
     float32 line is the one `bound` records); generalized FAVOR+ linear attention (H),
     float32 and bfloat16, at (P, L) = (8 * 512, 512), bench_kernels.py's
     shape at L=512, and at a ragged (7, 77), in bf16 with the share of
     outputs bit-equal to the plain version's (>= 0.99: JAX's float32
     feature maps and ctx) and, at the main shape, the device time beside
     the bound of the work its high/low split issues (`split_bound_ms`);
     the pair-track kernels at L=128 (B=4) and L=250 (B=1): fused LN + FAVOR+
     + residual (C) over both axes, with and without LN/residual; fused LN +
     FF + residual (D); outer-product mean (E) at each N of PATH_NS; 3x3 conv (F)
     at dilations 1/2/4/8 with and without the pre-op, beside cuDNN's conv at each
     dilation, logging the pre-op's cost in bf16; and C (LN + residual,
     both axes), D, E (at the request's N) and F in bfloat16 at B=1, L=512
     and L=1100, their plain versions in row slices of 128; C also at
     ragged (B, L) = (3, 77) and (1, 9) (problems and positions off the FAVOR+
     launch's tiles, rows off the projection's and output launch's 128-row
     blocks), both axes, with and without LN/residual; D at 5929, 100 and 128
     rows (off, below and on its 128-row blocks); the C and D wrappers' host
     time a call at the main shape, weights passed as the model passes them
     (`host_ms`). Each shape logs
     max|d| against its bound, the kernel's and the plain version's CUDA-event
     ms (beside a library call: kernel and library timed in turns, kernel,
     library, library, kernel), and the least time the card could take
     (`bound`); at A's main shape also A's and SDPA's device time
     (torch.profiler), at C's each of its three launches' device time beside
     its own bound (`launches_ms`, `launch_bound_ms`), at D's its device time
     beside its bound (`device_ms`, `launch_bound_ms`), E's device time at the
     main shape and at L=1100, N=32 (`device_ms`);
  3b. the backward kernels against their plain backward versions, float32
     and bfloat16: tied attention's (G) at L in {128, 250}, N in {8, 16},
     B*H = 48, from kernel A's output and lse; the FAVOR+ layer's (C') over
     both axes, with and without LN, at L=128 (B=4) and L=250 (B=1), at the
     main shape each of its five launches' device time beside its own bound
     (`launches_ms`, `launch_bound_ms`); F's float32-output input gradient at
     dilations 1/2/4/8; the same logs, and the library yardsticks (SDPA's
     backward through torch.autograd.grad, which accumulates into no .grad;
     cuDNN's conv input gradient at each dilation); at G's main shape also
     20 alternating turns of G and SDPA's backward (median and range, `turns`)
     and both sides' device time (torch.profiler); and F's weight
     gradient at B=4, L=128 (nine bf16 products summed in float32, as JAX)
     beside the bf16-rounded sums it replaced (`weight_grad_ms`);
  3c. kernel LN (the model's LayerNorm; it replaces no TPU kernel) against
     `layer_norm` at the pair shapes of L = 384 and L = 1100 in bfloat16, at
     the MSA's (1, 64, 384, 384) in float32, also as the sequence-wise
     layers' transposed view, and at the SE(3) layers' float32 (1, 1100,
     361) and (1, 1100, 2304): max|d|, the kernel's CUDA-event and device ms
     beside its byte bound and the plain version's ms; phases 4 and 4b
     require every LayerNorm call of their forwards to launch it
     (`layers.plain_calls` unchanged);
  3d. kernel IN (the pair ResNets' InstanceNorm statistics and affine + ELU
     epilogue; it replaces no TPU kernel either) against `instance_stats` and
     `affine_elu_rows` at the served shapes (B=4 at L=128, the ragged L = 250,
     L = 384 and 1100, bf16): inv / shift within 1e-5 of the largest, the
     epilogue's bf16 outputs, with the residual (the blocks' form) and without
     (the input norms'), at least 99.9 % bit-equal and all within one bf16
     ulp; each entry point's CUDA-event and device ms beside its byte bound and
     the plain version's ms; phases 4 and 4b require every InstanceNorm
     decision of their forwards to launch it (`resnet.plain_calls` unchanged:
     engagement share 1.0) and IN to run 77 times a forward at L >= 128
     (23 conv blocks x 3, 4 input norms x 2) and never below;
  4. serving: requests through `predict()` with the fast preset, made from
     examples/demo_casp.a3m (crop 64 / n_seq 64, crop 96 / 32, crop 120 / 8,
     crop 128 / 64, the whole chain L=250 / 32), each timed over repeated warm
     forwards, then batched forwards at B=4, N=8, L=120 and L=128; every
     forward at L >= 128 must launch A/B/C/D/E/F 21/12/56/28/7/46 times, every
     one below 128 A/B 21/12 and no pair-track kernel;
  4b. long chains: requests through `predict()` with the fast preset from a
     synthetic A3M written at run time (examples/make_demo_a3m.py, L=1100):
     crop 512 / n_seq 64 (bucketed SE(3), S=272 / 80) and the whole L=1100 /
     n_seq 32 (also the head row-chunked by 512: chunks 512, 512, 76), timed
     over 10 and 3 warm forwards; each forward must launch A/B-gather/C/D/E/F
     21/12/56/28/7/46 times, dense B and H never; each request's bucket
     overflow; a profile of one L=1100 forward; then H's own path, its
     wrapper called as a caller would at the bench shape;
  4c. the other serving options, at flagship width with one set of seed-0
     weights: the exact scatter SE(3) layout at crop 512 / n_seq 64 of the
     synthetic A3M through `predict()` (bf16, kernels), timed over 3 warm
     forwards beside the bucket layout's, launching what the bucket request
     launches but kernel B (0: the scatter layout runs plain segment ops, as
     in JAX), with max|d| of its logits and xyz against the bucket's and the
     bucket's overflow; the float32 plain scatter path against the float32
     plain dense one at crop 128 of the demo A3M, held to the full-depth
     envelope, the first three-track block's edge sets identical; a
     template (1, L, L, 64) from a seeded generator at L=250 / n_seq 32: the
     bf16 kernel path launching what the L=250 request launches, the float32
     kernel path against the float32 plain path held to the envelope, and
     the bf16 path's gap to the float32 plain one logged beside the same gap
     without the template (the bf16 trunk alone is outside the envelope at
     full depth); long_chunk=128 on the exact preset (float32, plain) at crop
     512 against the unchunked run: the two-track stack's (msa, pair) and
     the first three-track block's input CA within 1e-4 and its edge sets
     equal, the whole model on the unchunked run's neighborhoods within the
     envelope (the unpinned gap logged), the peak memory of each (the
     chunked run must hold less); and long_chunk on `fast_config(512)`
     launching what the unchunked request launches;
  5. end to end: requests with the same weights through attn_impl="pallas"
     and "xla" at float32 (crop 96 and crop 128 of the demo A3M, crop 400 of
     the synthetic one: bucketed SE(3)); per block, how far apart the CA
     coordinates of the two paths' neighborhoods lie and how many edges
     differ. Where every block's edges agree, the two paths are held to the
     full-depth envelope (logits max|d| <= 1e-2, xyz <= 0.4). Where a block's
     kNN picked other edges (a near-tie of two distances, which float32 sums
     taken in another order may flip), the plain path runs once more on the
     kernel path's neighborhoods and that run is held to the envelope, as 4c
     holds long_chunk; the unpinned gap and the flipped edges are logged;
  6. profile: torch.profiler over one warm B=4, N=8, L=128 forward: device
     busy share and the top device-time operators; every profile (4b, 6, 7)
     also logs the device kernels of A-H (PROFILED): calls and ms a call;
  7. training: train.loop.fit with bench_train.py's configuration (bf16,
     kernels, dense SE(3), remat, dropout 0.1, bf16 first moments) on a
     synthetic (A3M, PDB) pair, at B=1 / n_seq 8 / crop 128 and B=4 / n_seq
     16 / crop 128: ms/step, peak memory, finite loss and gradient norm, and
     each kernel launched as often per step as the code implies (KERNELS);
     the profile of a warm B=4 step; a falling loss on one fixed batch; and
     the float32 gradient envelope of the kernel path against the plain path
     at both shapes (loss within 1e-3 relative, gradient cosine >= 0.999,
     norms within 1e-2);
  8. mesh: kernels A, G, C and C' split over tp = 2 and 4 as the tensor-
     parallel train step splits them (A and G by blocks of the B*H = 12 head
     problems at L = 128, N = 8; C and C' by blocks of the row problems at
     (128, 128, 288) with flagship weights), each shard launched alone: the
     joined outputs bit-equal to one whole launch, C''s weight-gradient
     partials summed within phase 3b's bf16 bound; times a shard beside the
     whole launch's. Then an NCCL process group of one rank on this card:
     parallel.dryrun at tiny width, and fit through make_mesh(1) (dp = tp = 1)
     at phase 7's configuration, B=1 / n_seq 8 / crop 128, 2 steps, its
     launches counted, against fit without a mesh: losses and parameters
     bit-equal (both on deterministic algorithms: cuDNN's default weight-
     gradient sums vary from run to run). The machine has one card: no run
     on several is made;
then prints one JSON line of kernel results and, last, the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
A3M = os.path.join(ROOT, "examples", "demo_casp.a3m")
REQUESTS = ((64, 64), (96, 32), (120, 8), (128, 64), (250, 32))  # (crop, n_seq)
BATCHES = ((4, 8, 120), (4, 8, 128))                            # (B, N, L)
TRAIN_SHAPES = ((1, 8, 128), (4, 16, 128))  # (B, n_seq, crop): bench_train's, train_cli's
# every MSA depth the main path gives kernels A and E
PATH_NS = tuple(sorted({n for _, n in REQUESTS} | {n for _, n, _ in BATCHES + TRAIN_SHAPES}))
REPS = 10  # warm forwards timed per request and batch
LONG_A3M = (1100, 80, 1)  # (L, rows, seed) of the synthetic long-chain A3M
LONG_REQUESTS = ((512, 64, 10), (1100, 32, 3))  # (crop, n_seq, warm forwards timed)
# (L, n_seq) of each long request: phase 3 holds the kernels at these shapes
LONG_PATH = tuple((c, n) for c, n, _ in LONG_REQUESTS)
# phase 4c: the scatter SE(3) layout and long_chunk at crop 512 of the long A3M,
# the scatter-vs-dense envelope at crop 128 and the template at L=250 (demo A3M)
CFG_CROP, CFG_N_SEQ, CFG_REPS = 512, 64, 3  # crop, n_seq, warm forwards timed
CFG_DENSE_CROP, CFG_TEMPLATE = 128, (250, 32)  # (crop, n_seq)
CFG_LONG_CHUNK, CFG_CHUNK_TOL = 128, 1e-4
H_SHAPE = (8 * 512, 512)  # bench_kernels.py's FAVOR+ shape at L=512: P = L * 8 heads
H_PATH_CALLS = 3
# least share of H's bf16 outputs equal to the plain version's: JAX's rounding
# points (float32 feature maps, ctx, normalizer) give about 0.999 at the main
# shape, feature maps and ctx rounded to bf16 about 0.81 (probes/la_variants.py)
H_BIT_EQUAL = 0.99


class Kernel(NamedTuple):
    module: str          # module of ops/cuda
    counter: str         # its launch counter
    source: str          # CUDA source in csrc/
    replaces: str        # TPU kernel it replaces, under rosettafold_tpu/ops/pallas/
    per_fwd: int         # launches per serving forward at 128 <= L <= 384
    per_train_step: int  # per train step at L = 128 with dropout and remat on (each
                         # forward kernel runs again in its remat'd block's recompute)
    per_long_fwd: int    # per serving forward at L > 384 (bucketed SE(3): B gather)


KERNELS = {
    "tied_attention": Kernel("tied_attention", "launches", "tied_attention.cu",
                             "tied_attention.py:99", 21, 42, 21),
    "se3_attend": Kernel("se3_attend", "launches", "se3_attend.cu", "se3_attend.py:486",
                         12, 24, 0),
    "se3_attend_gather": Kernel("se3_attend", "gather_launches", "se3_attend.cu",
                                "se3_attend.py:486", 0, 0, 12),
    "fused_performer": Kernel("fused_performer", "launches", "fused_performer.cu",
                              "fused_performer.py:398", 56, 112, 56),
    "fused_ff": Kernel("fused_ff", "launches", "fused_ff.cu", "fused_ff.py:58", 28, 0, 28),
    "outer_product": Kernel("outer_product", "launches", "outer_product.cu",
                            "outer_product.py:88", 7, 14, 7),
    "conv3x3": Kernel("conv3x3", "launches", "conv3x3.cu", "conv3x3.py:134", 46, 92, 46),
    "tied_attention_bwd": Kernel("tied_attention", "bwd_launches", "tied_attention_bwd.cu",
                                 "tied_attention.py:241", 0, 21, 0),
    "fused_performer_bwd": Kernel("fused_performer", "bwd_launches", "fused_performer_bwd.cu",
                                  "fused_performer.py:601", 0, 56, 0),
    "conv3x3_bwd": Kernel("conv3x3", "bwd_launches", "conv3x3.cu", "conv3x3.py:222", 0, 46, 0),
    # on no model path: its path is its wrapper (phase 4b)
    "linear_attention": Kernel("linear_attention", "launches", "linear_attention.cu",
                               "linear_attention.py:82", 0, 0, 0),
}
SOURCES = sorted({k.source[:-3] for k in KERNELS.values()} | {"layer_norm", "instance_norm"})
# kernel IN's calls a serving forward at L >= 128: each of the 23 conv blocks
# (F's two launches a block) takes two statistics and an epilogue, each of the
# four head ResNets' input norms a statistics and an epilogue
IN_PER_FWD = KERNELS["conv3x3"].per_fwd // 2 * 3 + 4 * 2
# phase 3c: kernel LN's shapes, (x shape, dtype, the transposed view): the
# pair at L = 384 and 1100 (16-byte loads, one pass), the MSA and the
# sequence-wise layers' view of it, and the SE(3) self-interaction's Gram
# rows at L = 1100 (models/se3.py `ln_1`, C = 19^2: one element a load;
# `ln_0`, C = 48^2: each row read twice)
LN_SHAPES = (((1, 384, 384, 288), "bfloat16", False), ((1, 1100, 1100, 288), "bfloat16", False),
             ((1, 64, 384, 384), "float32", False), ((1, 64, 384, 384), "float32", True),
             ((1, 1100, 361), "float32", False), ((1, 1100, 2304), "float32", False))
# phase 3d: kernel IN's shapes, the pair ResNets' maps as served: B=4 at L=128
# (the batched forward), L = 250 (the whole demo chain: 62,500 pixels, 4 past a
# multiple of 16, so the pixel loops' tail runs), L = 384 (the short requests'
# longest) and 1100
IN_SHAPES = ((4, 128, 128, 288), (1, 250, 250, 288), (1, 384, 384, 288),
             (1, 1100, 1100, 288))
PAIR_KERNELS = ("fused_performer", "fused_ff", "outer_product", "conv3x3")
# float32 tolerances (atol, rtol): those of the JAX kernel tests (A 2e-5, B
# 2e-5 on both layouts, C 3e-5, D, E, F 2e-5, H 3e-5 absolute,
# tests/test_pallas.py:109) and of its gradient tests (G 3e-5,
# tests/test_pallas.py:41,166; C' 2e-4 / 1e-3, :268,320; F's backward 2e-5,
# tests/test_conv3x3.py:99). bfloat16: two bf16 ulps of the plain value
# (2^-6 relative) + 1e-2: both sides round the same intermediates, in other
# summation orders.
F32_TOL = {"tied_attention": (2e-5, 2e-5), "se3_attend": (2e-5, 2e-5),
           "se3_attend_gather": (2e-5, 2e-5), "linear_attention": (3e-5, 0.0),
           "fused_performer": (3e-5, 3e-5), "fused_ff": (2e-5, 2e-5),
           "outer_product": (2e-5, 2e-5), "conv3x3": (2e-5, 2e-5),
           "tied_attention_bwd": (3e-5, 0.0), "fused_performer_bwd": (2e-4, 1e-3),
           "conv3x3_bwd": (2e-5, 2e-5)}
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -6
# device kernels of A (csrc/tied_attention.cu: the bf16 one-launch kernel at
# L <= 128, 64 < NDv <= 256, the bf16 logits and P.V launches, the float32
# kernel), B (csrc/se3_attend.cu, both layouts), C (csrc/fused_performer.cu:
# the bf16 q/k/v projection (csrc/performer_wg.cuh, which C' also launches
# for its q/k/v), FAVOR+ and output launches, the float32 ones), C'
# (csrc/fused_performer_bwd.cu: the bf16 go projection, FAVOR+ backward, dx,
# weight-gradient partials, their sum, the float32 ones), D (csrc/fused_ff.cu:
# bf16, float32), E (csrc/outer_product.cu: bf16, float32), F
# (csrc/conv3x3.cu: the bf16 conv, its pre-op launch, the float32 conv) and G
# (csrc/tied_attention_bwd.cu: dsum, the bf16 p / ds and gradient launches,
# the float32 ones) and H (csrc/linear_attention.cu: bf16, float32); each
# profile logs their calls and time (a name matches the kernels whose name
# holds it)
PROFILED = {"A": ("tied_fused_kernel", "tied_logits_kernel", "tied_pv_kernel", "tied_fwd_f32"),
            "B": ("se3_attend_kernel",),
            "C": ("proj_wgmma_kernel<24, false>", "performer_proj_kernel", "favor_wgmma_kernel",
                  "favor_f32_kernel", "out_wgmma_kernel<8>", "performer_out_kernel"),
            "C'": ("proj_wgmma_kernel<8, true>", "favor_bwd_wgmma_kernel", "out_wgmma_kernel<24>",
                   "wgrad_wgmma_kernel", "wgrad_reduce_kernel", "::proj_kernel<float>",
                   "::favor_kernel<float>", "::dx_kernel<float>", "::wgrad_kernel<float>"),
            "D": ("ff_wgmma_kernel", "fused_ff_kernel"),
            "E": ("opm_wgmma_kernel", "opm_f32_kernel"),
            "F": ("conv3x3_tma_kernel", "pre_op_kernel", "conv3x3_kernel"),
            "G": ("tied_bwd_dsum_kernel", "tied_bwd_sdp_kernel", "tied_bwd_grad_kernel",
                  "dkv_f32_kernel", "dq_f32_kernel"),
            "H": ("la_wgmma_kernel", "la_f32_kernel"),
            "LN": ("ln_rows_kernel",),
            "IN": ("instance_stats_kernel", "instance_combine_kernel", "instance_apply_kernel")}
# ms a call the wrappers' host side takes is timed over this many calls
HOST_CALLS = 50
E2E_LOGITS, E2E_XYZ = 1e-2, 0.4
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32 CUDA
# cores, TF32 tensor cores in three passes (B's float32 products), HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_S = 3.35e12


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """Fail the run (unlike `assert`, also under python -O)."""
    if not ok:
        raise AssertionError(what)


def cuda_time(fn, iters=10):
    """Mean milliseconds per call, CUDA events around `iters` calls after
    min(2, iters) warm-up calls."""
    import torch

    for _ in range(min(2, iters)):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def bound(plain, args, out, dtype, work_share=1.0):
    """(ms, "operations" | "bytes"): the least time the card could take.
    Operations: the matrix-product operations of the plain version on these
    inputs (torch.utils.flop_counter), times the share of the work these
    inputs need (masked edges are skipped), over the peak rate of `dtype`;
    bytes: each input read once and each output written once, over HBM."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        plain(*args)
    flops = counter.get_total_flops() * work_share
    nbytes = sum(t.numel() * t.element_size() for t in _tensors((args, out)))
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class Results:
    """Per kernel: the worst max|d| over phase 3 and the main shape's times."""

    def __init__(self):
        self.kernels = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def by_dilation(self, name, dil, ms, library_ms):
        """F's and F-bwd's main-shape times at each dilation, beside the library's."""
        self.kernels[name].setdefault("by_dilation", {})[str(dil)] = {
            "ms": ms, "library_ms": library_ms}

    def case(self, name, tag, kernel, plain, args, dtype_name, main=False, library=None,
             work_share=1.0, iters=10, grad=False, by_shape=False):
        import torch

        out = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        pairs = list(zip(_tensors(out), _tensors(ref)))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
        if dtype_name == "float32":
            atol, rtol = F32_TOL[name]
            ok = all(torch.allclose(a, b, atol=atol, rtol=rtol) for a, b in pairs)
            what = f"atol {atol} rtol {rtol}"
        else:
            # a gradient has no unit scale: its absolute term is 1e-2 of the
            # output's largest magnitude where that exceeds 1 (each term of a
            # backward sum rounds in bf16, e.g. ds before dq, so a rounding
            # flip moves the sum in proportion to the terms, not the result)
            def atol(b):
                return BF16_ATOL * (max(1.0, float(b.abs().max())) if grad else 1.0)
            ok = all(bool(((a.float() - b.float()).abs()
                           <= atol(b.float()) + BF16_RTOL * b.float().abs()).all())
                     for a, b in pairs)
            what = f"atol {BF16_ATOL}{' x max(1, max|ref|)' if grad else ''} rtol 2^-6"
        def run():
            return kernel(*args)
        if library is None:
            ms, lib_ms = cuda_time(run, iters), None
        else:  # in turns (kernel, library, library, kernel): a drift of the host hits both
            turns = [cuda_time(f, iters) for f in (run, library, library, run)]
            ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = cuda_time(lambda: plain(*args), iters)
        bound_ms, bound_by = bound(plain, args, out, dtype_name, work_share)
        lib = "" if lib_ms is None else f" library {lib_ms:.4f} ms"
        log(f"{name} {tag} {dtype_name}: max|d| {err:.3e} ({what}) kernel {ms:.4f} ms"
            f" plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}){lib}")
        if not ok:
            for i, (a, b) in enumerate(pairs):
                d = (a.float() - b.float()).abs()
                at = int(d.argmax())
                log(f"  output {i}: max|d| {float(d.max()):.3e} at ref {float(b.flatten()[at]):.4e},"
                    f" max|ref| {float(b.abs().max()):.3e}")
        require(ok, f"{name} disagrees with its plain version at {tag} {dtype_name}")
        rec = self.kernels[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if main:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
        if by_shape:  # a served shape besides the main one
            rec.setdefault("by_shape", {})[tag] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
        return ms, lib_ms


def phase_device():
    import torch

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from rosettafold_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all(SOURCES)
    log(f"build: {len(build.build_log)} sources in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        build.load(name)
        secs, out = build.build_log.get(name, (0.0, ""))
        log(f"build {name}: {secs:.2f} s")
        for line in _ptxas_lines(out):
            log("  " + line)


def _kernel_name(mangled):
    """The kernel's own name out of its mangled one (length-prefixed
    identifiers), with <bf16> / <float> for the kernels templated on them."""
    pos = mangled.find("kernel")
    if pos < 0:
        return mangled[-60:]
    end = pos + len("kernel")
    for start in range(pos, 0, -1):
        digits = str(end - start)
        if mangled[start - len(digits):start] == digits:
            rest = mangled[end:]
            tpl = ("<bf16>" if rest.startswith("I13__nv_bfloat16")
                   else "<float>" if rest.startswith("If")
                   else f"<{rest[3:rest.index('E')]}>" if rest.startswith("ILi") else "")
            return mangled[start:end] + tpl
    return mangled[-60:]


def _ptxas_lines(out):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name,
    registers, stack and spills; and any warning of serialised wgmma (C75xx)."""
    lines, entry, props = [], None, ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_name(line.split("'")[1] if "'" in line else line)
        elif "stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line and entry is not None:
            lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {props}")
            entry, props = None, ""
        elif "(C75" in line and "C7519" not in line:
            lines.append(line.strip()[:200])
    return lines


def _dt(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def phase_tied(res):
    import torch
    import torch.nn.functional as F

    from rosettafold_tpu_torch.ops.cuda import tied_attention as ta

    g = torch.Generator(device="cuda").manual_seed(0)
    for L in (77, 120, 128, 250):
        BH = 5 if L == 77 else (4 if L <= 128 else 1) * 12
        for N in PATH_NS:
            ND = N * 32
            q, k = (torch.randn(BH, L, ND, device="cuda", generator=g) * 0.3 for _ in range(2))
            v = torch.randn(BH, L, ND, device="cuda", generator=g)
            for dname in ("float32", "bfloat16"):
                args = tuple(t.to(_dt(dname)) for t in (q, k, v))
                main = (L, N, dname) == (128, 8, "bfloat16")  # the batched serving shape
                lib = None
                if main:
                    qs, ks, vs = (t[:, None] for t in args)
                    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)  # noqa
                res.case("tied_attention", f"B*H={BH} L={L} N={N}", ta.tied_attention_forward,
                         ta.tied_attention_plain, args, dname, main=main, library=lib,
                         iters=10 if main else 3)
                if main:  # at this size the CUDA-event times above are the host's
                    dev = {k: _device_ms(f) for k, f in (
                        ("device_ms", lambda: ta.tied_attention_forward(*args)),
                        ("library_device_ms", lib))}
                    log(f"tied_attention B*H={BH} L={L} N={N} bfloat16: device time a call"
                        f" {dev['device_ms']:.4f} ms, SDPA's {dev['library_device_ms']:.4f} ms")
                    res.kernels["tied_attention"].update(dev)
    for L, N in LONG_PATH:  # the long requests: B=1, bf16 as served
        q, k = (_normal((12, L, N * 32), 0.3, g, torch.bfloat16) for _ in range(2))
        v = _normal((12, L, N * 32), 1.0, g, torch.bfloat16)
        qs, ks, vs = (t[:, None] for t in (q, k, v))
        res.case("tied_attention", f"B*H=12 L={L} N={N}", ta.tied_attention_forward,
                 ta.tied_attention_plain, (q, k, v), "bfloat16", iters=3, by_shape=True,
                 library=lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0))


def _device_ms(fn, name="", calls=20):
    """Device time a call of fn's kernels whose name holds `name` (all of
    them by default): torch.profiler's sum over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
               if name in e.key) / 1e3 / calls


def phase_se3(res):
    import torch

    from rosettafold_tpu_torch.models.rosettafold import init_like_flax
    from rosettafold_tpu_torch.models.se3 import SE3Transformer
    from rosettafold_tpu_torch.ops import knn, so3
    from rosettafold_tpu_torch.ops.cuda import se3_attend as sa

    B, L, dev = 4, 128, "cuda"  # the batched serving shape
    g = torch.Generator(device="cpu").manual_seed(1)
    se3 = SE3Transformer(num_layers=2, num_channels=16, n_heads=4, num_degrees=2,
                         l0_in_features=64, l1_in_features=3, l0_out_features=32,
                         l1_out_features=3, num_edge_features=64, impl="pallas")
    init_like_flax(se3, g)
    se3 = se3.to(dev)
    xyz = torch.randn(B, L, 3, 3, generator=g).to(dev) * 8.0
    aa = torch.arange(L, device=dev)[None].repeat(B, 1)
    mask = knn.incoming_mask(knn.knn_adjacency(xyz, aa, 64)).contiguous()
    share = float(mask.float().mean())  # the kernel skips masked edges
    ca = xyz[:, :, 1]
    rel = ca[:, :, None, :] - ca[:, None, :, :]
    basis = {k: v.contiguous() for k, v in so3.equivariant_basis(rel, 1).items()}
    feat = torch.cat([torch.randn(B, L, L, 64, generator=g).to(dev),
                      so3.edge_radii(rel)], dim=-1).contiguous()
    for name in ("res_0", "res_1", "res_out"):
        mod = getattr(se3, name)
        h = {d: torch.randn(B, L, m, 2 * d + 1, generator=g).to(dev)
             for d, m in mod.f_in.dict.items()}
        ck = sum((m // mod.n_heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
        qh = torch.randn(B, L, mod.n_heads * ck, generator=g).to(dev)
        with torch.no_grad():
            stacked = sa.stack_weights(mod.v, mod.k, mod.meta)
            args = (feat, basis, h, mask, qh, stacked, mod.meta)
            res.case("se3_attend", f"{name} B={B} L={L}", sa.gse3_attend, sa.se3_attend_plain,
                     args, "float32", main=name == "res_1", work_share=share)
            if name == "res_1":
                _se3_device(res, "se3_attend", f"{name} B={B} L={L}", sa, args, share)


def phase_se3_gather(res):
    """B on its gather layout at the three GSE3Res layer shapes: bucket
    src_idx of a random-walk backbone at each long request's L (512, 1100)
    with the three-track blocks' K_max = 128 (S = 272) and the final block's
    K = 32 (S = 80), and at a ragged L=77, K=16 (S = 48)."""
    import numpy as np
    import torch

    from rosettafold_tpu_torch.models.rosettafold import init_like_flax
    from rosettafold_tpu_torch.models.se3 import SE3Transformer
    from rosettafold_tpu_torch.ops import knn, so3
    from rosettafold_tpu_torch.ops.cuda import se3_attend as sa

    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(4)
    se3 = SE3Transformer(num_layers=2, num_channels=16, n_heads=4, num_degrees=2,
                         l0_in_features=64, l1_in_features=3, l0_out_features=32,
                         l1_out_features=3, num_edge_features=64, impl="pallas")
    init_like_flax(se3, g)
    se3 = se3.to(dev)
    shapes = [(L, K) for L, _ in LONG_PATH for K in (128, 32)] + [(77, 16)]
    for L, K in shapes:
        xyz = torch.from_numpy(_backbone(L, np.random.default_rng(L + K))).float()[None].to(dev)
        src, mask, overflow = knn.knn_bucket_indices(xyz, torch.arange(L, device=dev)[None], K)
        S = src.shape[-1]
        share = float(mask.float().mean())  # the kernel skips masked slots
        log(f"bucket L={L} K={K}: S={S}, {share:.3f} of the slots hold edges,"
            f" overflow {int(overflow.sum())}")
        ca = xyz[:, :, 1]
        rel = ca[:, :, None, :] - ca[0][src.long()]
        basis = {k: v.contiguous() for k, v in so3.equivariant_basis(rel, 1).items()}
        feat = torch.cat([torch.randn(1, L, S, 64, generator=g).to(dev),
                          so3.edge_radii(rel)], dim=-1).contiguous()
        for name in ("res_0", "res_1", "res_out"):
            mod = getattr(se3, name)
            h = {d: torch.randn(1, L, m, 2 * d + 1, generator=g).to(dev)
                 for d, m in mod.f_in.dict.items()}
            ck = sum((m // mod.n_heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
            qh = torch.randn(1, L, mod.n_heads * ck, generator=g).to(dev)
            main = (name, L, S) == ("res_1", 512, 272)
            long = name == "res_1" and L == 1100  # phase 4b's long shapes
            with torch.no_grad():
                args = (feat, basis, h, mask, qh, sa.stack_weights(mod.v, mod.k, mod.meta),
                        mod.meta, src)
                tag = f"{name} L={L} S={S}"
                res.case("se3_attend_gather", tag, sa.gse3_attend, sa.se3_attend_plain, args,
                         "float32", main=main, work_share=share, iters=10 if main else 3,
                         by_shape=long)
                if main or long:
                    _se3_device(res, "se3_attend_gather", tag, sa, args, share,
                                None if main else tag)


def _se3_device(res, name, tag, sa, args, share, shape=None):
    """B's device time a call (torch.profiler) and its bound on the 3xTF32
    tensor-core line (495 / 3 TFLOP/s) beside the float32 line that `case`
    records, into the main record or, with `shape`, that shape's record."""
    out = sa.gse3_attend(*args)
    dev = _device_ms(lambda: sa.gse3_attend(*args))
    tc_ms, tc_by = bound(sa.se3_attend_plain, args, out, "tf32x3", share)
    log(f"{name} {tag} float32: device time a call {dev:.4f} ms; bound on the 3xTF32 line"
        f" {tc_ms:.4f} ms ({tc_by})")
    rec = res.kernels[name] if shape is None else res.kernels[name]["by_shape"][shape]
    rec.update(device_ms=dev, bound_tf32x3_ms=tc_ms)


def phase_linear_attention(res):
    """H at bench_kernels.py's shape at L=512 (q, k at 0.1 std, the seed-0
    projection cast to the dtype) and at a ragged (7, 77). bf16: the share of
    outputs equal to the plain version's (the float32 result rounded once)
    must reach H_BIT_EQUAL; at the main shape also the bf16 kernel's device
    time and the bound of the work its bf16 high/low split issues."""
    import torch

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import linear_attention as la

    g = torch.Generator(device="cuda").manual_seed(5)
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 0)).float().cuda()
    rec = res.kernels["linear_attention"]
    for P, L in (H_SHAPE, (7, 77)):
        q, k = (_normal((P, L, 64), 0.1, g) for _ in range(2))
        v = _normal((P, L, 64), 1.0, g)
        for dname in ("float32", "bfloat16"):
            main = ((P, L), dname) == (H_SHAPE, "bfloat16")
            args = tuple(t.to(_dt(dname)) for t in (q, k, v, proj))
            res.case("linear_attention", f"P={P} L={L}", la.generalized_linear_attention,
                     la.linear_attention_plain, args, dname, main=main,
                     iters=10 if main else 3)
            if dname == "float32":
                continue
            share = float((la.generalized_linear_attention(*args)
                           == la.linear_attention_plain(*args)).float().mean())
            log(f"linear_attention P={P} L={L} bfloat16: {share:.6f} of the outputs equal the"
                f" plain version's (>= {H_BIT_EQUAL})")
            require(share >= H_BIT_EQUAL, f"H's bf16 outputs at P={P} L={L} leave the float32"
                                          f" rounding points: {share:.6f} bit-equal")
            rec.setdefault("bit_equal_share", {})[f"P={P} L={L}"] = share
            if main:
                m = proj.shape[0]
                dev = _device_ms(lambda: la.generalized_linear_attention(*args),
                                 "la_wgmma_kernel", calls=10)
                # 2 feature maps, ctx from hi and lo, num from hi.hi, hi.lo, lo.hi
                flops = 2.0 * P * L * m * 64 * (2 + 2 + 3)
                nbytes = 4 * P * L * 64 * 2 + m * 64 * 2
                split_ms = max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_S) * 1e3
                log(f"linear_attention P={P} L={L} bfloat16: device time a call {dev:.4f} ms;"
                    f" bound of the split's work ({flops:.3e} FLOP) {split_ms:.4f} ms, of the"
                    f" function's {rec['bound_ms']:.4f} ms")
                rec.update(device_ms=dev, split_bound_ms=split_ms)
        del q, k, v


def _normal(shape, std, g, dtype=None):
    import torch

    t = torch.randn(*shape, generator=g, device="cuda") * std
    return t if dtype is None else t.to(dtype)


def _in_rows(plain, rows, dim, out_dim=None):
    """`plain` over slices of its first argument along `dim`, `rows` at a
    time, the outputs joined along `out_dim` (default `dim`): the same
    function in bounded memory, for the long shapes whose float32
    intermediates would not fit whole. `rows` None: `plain` itself."""
    import torch

    if rows is None:
        return plain
    out_dim = dim if out_dim is None else out_dim

    def run(x, *rest):
        n = x.shape[dim]
        return torch.cat([plain(x.narrow(dim, lo, min(rows, n - lo)), *rest)
                          for lo in range(0, n, rows)], out_dim)
    return run


def phase_layer_norm():
    """Phase 3c: kernel LN against `layer_norm` (LN_SHAPES); its records by shape."""
    import torch

    from rosettafold_tpu_torch.models.layers import layer_norm
    from rosettafold_tpu_torch.ops.cuda import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for shape, dname, view in LN_SHAPES:
        x = (_normal(shape, 1.0, g) + 0.5).to(_dt(dname))
        x = x.transpose(1, 2) if view else x
        C = shape[-1]
        w, b = 1.0 + _normal((C,), 0.1, g), _normal((C,), 0.1, g)

        def kernel():
            return ln.fused_layer_norm(x, w, b, 1e-5)

        got, want = kernel(), layer_norm(x, w, b, 1e-5)
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, atol=2e-5, rtol=2e-5)
        del got, want
        tag = f"{tuple(x.shape)} {dname}{' transposed' if view else ''}"
        require(ok, f"LN disagrees with layer_norm at {tag}: max|d| {err:.3e}")
        ms = cuda_time(kernel, 20)
        # a profile that recorded no device time (seen once) is not measured
        device_ms = _device_ms(kernel, "ln_rows_kernel", calls=10) or None
        plain_ms = cuda_time(lambda: layer_norm(x, w, b, 1e-5), 5)
        bound_ms = (x.numel() * (x.element_size() + 4) + 2 * C * 4) / HBM_BYTES_S * 1e3
        share = "not measured" if device_ms is None else f"{bound_ms / device_ms:.1%} of it"
        log(f"layer_norm {tag}: max|d| {err:.3e} (atol 2e-5 rtol 2e-5) kernel {ms:.4f} ms"
            f" device {device_ms} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms"
            f" (bytes; device time {share})")
        out[tag] = {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms}
        del x
    return out


def _bf16_gap(got, ref):
    """(share of outputs bit-equal, max|d|, every output within one bf16 ulp
    of ref, 2^-7 |ref|) of two outputs of the same float32 steps."""
    equal = float((got == ref).float().mean())
    d = (got.float() - ref.float()).abs()
    within = bool((d <= 2.0 ** -7 * ref.float().abs().clamp_min(2.0 ** -126)).all())
    return equal, float(d.max()), within


def phase_instance_norm():
    """Phase 3d: kernel IN against `instance_stats` and `affine_elu_rows`
    (IN_SHAPES), the epilogue with the residual (the blocks') and without
    (the input norms'); its records by shape and entry point."""
    import torch

    from rosettafold_tpu_torch.models import resnet
    from rosettafold_tpu_torch.ops.cuda import instance_norm as tin

    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for shape in IN_SHAPES:
        C = shape[-1]
        scale, offset = 0.5 + torch.rand(C, generator=g, device="cuda"), _normal((C,), 1.0, g)
        y = (_normal(shape, 1.0, g) * scale + offset).bfloat16()
        x = _normal(shape, 1.0, g, torch.bfloat16)
        w, b = 1.0 + _normal((C,), 0.1, g), _normal((C,), 0.1, g)
        tag = f"{shape} bfloat16"
        inv, shift = tin.instance_affine(y, w, b, 1e-6)
        want = resnet.instance_stats(y, w, b, 1e-6)
        err = max(float((a - c).abs().max() / c.abs().max()) for a, c in zip((inv, shift), want))
        require(err <= 1e-5, f"IN statistics disagree with instance_stats at {tag}: {err:.3e}")
        rec = {"stats_rel_err": err}
        forms = {"apply": x, "apply_no_residual": None}
        for name, res in forms.items():
            got = tin.instance_apply(y, inv, shift, res, torch.bfloat16)
            ref = resnet.affine_elu_rows(y, inv, shift, torch.bfloat16, 128, res)
            equal, gap, within = _bf16_gap(got, ref)
            del got, ref
            require(equal >= 0.999 and within,
                    f"IN {name} at {tag}: {equal:.5f} of its outputs bit-equal (0.999), max|d|"
                    f" {gap:.3e}, {'all' if within else 'not all'} within one bf16 ulp")
            rec[name] = {"bit_equal": equal, "max_abs_err": gap}
        calls = {
            "stats": (lambda: tin.instance_affine(y, w, b, 1e-6),
                      lambda: resnet.instance_stats(y, w, b, 1e-6), "instance_",
                      y.numel() * 2 + 4 * C * 4 * shape[0])}
        for name, res in forms.items():
            calls[name] = (lambda res=res: tin.instance_apply(y, inv, shift, res, torch.bfloat16),
                           lambda res=res: resnet.affine_elu_rows(y, inv, shift, torch.bfloat16,
                                                                  128, res),
                           "instance_apply_kernel",
                           y.numel() * (4 if res is None else 6) + 2 * C * 4 * shape[0])
        for name, (kernel, plain, dev_name, nbytes) in calls.items():
            ms = cuda_time(kernel, 20)
            device_ms = _device_ms(kernel, dev_name, calls=10) or None
            plain_ms = cuda_time(plain, 3)
            bound_ms = nbytes / HBM_BYTES_S * 1e3
            share = None if device_ms is None else bound_ms / device_ms
            log(f"instance_norm {name} {tag}: kernel {ms:.4f} ms device {device_ms} ms plain"
                f" {plain_ms:.4f} ms bound {bound_ms:.4f} ms (bytes; device time"
                f" {'not measured' if share is None else f'{share:.1%} of it'})")
            rec.setdefault(name, {}).update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                            bound_ms=bound_ms, bound_share=share)
        log(f"instance_norm {tag}: statistics rel err {err:.3e} (1e-5); epilogue bit-equal"
            f" {rec['apply']['bit_equal']:.5f} with the residual,"
            f" {rec['apply_no_residual']['bit_equal']:.5f} without, the rest within one bf16 ulp")
        out[tag] = rec
        del y, x
    return out


# the normalisation kernels' wrapper modules and the model modules whose
# `plain_calls` count the calls of their kernel path kept plain
NORMS = {"LN": ("layer_norm", "layers"), "IN": ("instance_norm", "resnet")}


def _norm_counts():
    """{kernel: (its launch counter, its plain calls)} so far, for LN and IN."""
    import importlib

    return {k: (importlib.import_module(f"rosettafold_tpu_torch.ops.cuda.{op}").launches,
                importlib.import_module(f"rosettafold_tpu_torch.models.{model}").plain_calls)
            for k, (op, model) in NORMS.items()}


def _norms_engaged(what, counts0, forwards, in_calls):
    """Every LayerNorm and InstanceNorm call of the kernel path since counts0
    launched its kernel (none kept plain: engagement share 1.0), and kernel
    IN ran exactly `in_calls` times."""
    for k, ((n, plain), (n0, plain0)) in zip(NORMS, zip(_norm_counts().values(),
                                                          counts0.values())):
        n, plain = n - n0, plain - plain0
        log(f"{what}: kernel {k} {n / forwards:.1f} calls a forward, {plain} plain calls,"
            f" engagement share {n / max(1, n + plain):.4f}")
        require(n > 0 and plain == 0,
                f"{what}: a {k} call on the kernel path took the plain version")
        if k == "IN":
            require(n == in_calls, f"{what}: kernel IN ran {n} times, not {in_calls}"
                    f" ({IN_PER_FWD} a forward at L >= 128)")


def phase_pair_kernels(res):
    """C, D, E, F at the serving shapes, (B, L) = (4, 128) and (1, 250) in
    float32 and bfloat16 at every N of PATH_NS, and at the long requests'
    (1, 512) and (1, 1100) in bfloat16 as served, C in its LN + residual
    form, E at the request's N; there the plain versions run in row slices
    of 128 (`_in_rows`)."""
    import torch
    import torch.nn.functional as F

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import conv3x3 as cv
    from rosettafold_tpu_torch.ops.cuda import fused_ff as ff
    from rosettafold_tpu_torch.ops.cuda import outer_product as op

    g = torch.Generator(device="cuda").manual_seed(2)
    D, HD, FF = 288, 512, 1152
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 42)).cuda()
    both = ("float32", "bfloat16")
    shapes = [(4, 128, both, PATH_NS, None), (1, 250, both, PATH_NS, None)]
    shapes += [(1, L, ("bfloat16",), (N,), 128) for L, N in LONG_PATH]
    for B, L, dnames, Ns, rows in shapes:
        x32 = _normal((B, L, L, D), 1.0, g)
        gam = 1.0 + _normal((D,), 0.1, g)
        bet = _normal((D,), 0.1, g)
        iters = 3 if rows is None else 1
        for dname in dnames:
            dt = _dt(dname)
            x = x32.to(dt)
            main = (B, L, dname) == (4, 128, "bfloat16")
            shape = f"B={B} L={L}"
            w = [_normal((D, HD), D ** -0.5, g, dt) for _ in range(3)]
            w += [_normal((HD, D), HD ** -0.5, g, dt), _normal((D,), 0.1, g, dt), proj]
            _performer_cases(res, x, gam, bet, w, shape, dname, rows, main, iters)
            # D
            args = (x, gam, bet, _normal((D, FF), D ** -0.5, g, dt), _normal((FF,), 0.1, g),
                    _normal((FF, D), FF ** -0.5, g, dt), _normal((D,), 0.1, g), 1e-5)
            res.case("fused_ff", shape, ff.fused_ln_ff_residual,
                     _in_rows(ff.fused_ff_plain, rows, 1), args, dname, main=main,
                     iters=10 if main else iters)
            if main:
                _ff_launch(res, lambda a=args: ff.fused_ln_ff_residual(*a), B * L * L)
            # E; its device time at the main shape and at the longest request
            for N in Ns:
                xo = _normal((B, N, L, 32), 1.0, g)
                yo = (xo * torch.rand(B, N, L, 1, generator=g, device="cuda")).to(dt)
                args = (xo, yo, 1.0 + _normal((1024,), 0.1, g), _normal((1024,), 0.1, g),
                        _normal((1024, D), 1 / 32, g, dt), _normal((D,), 0.1, g), 1e-5, dt)
                tag = f"{shape} N={N}"
                res.case("outer_product", tag, op.fused_outer_product_mean,
                         _in_rows(op.outer_product_plain, rows, 2, 1), args, dname,
                         main=main and N == 8, iters=10 if main and N == 8 else iters,
                         by_shape=rows is not None)
                if (main and N == 8) or (rows is not None and L == LONG_PATH[-1][0]):
                    ms = _device_ms(lambda a=args: op.fused_outer_product_mean(*a),
                                    "opm_wgmma_kernel", calls=10 if main else 3)
                    log(f"outer_product {tag} bfloat16: device time {ms:.4f} ms a call")
                    require(ms > 0, "no device time for E in the profile")
                    rec = res.kernels["outer_product"]
                    (rec if main else rec["by_shape"][tag])["device_ms"] = ms
            # F; at the main shape cuDNN's conv at each dilation (channels_last, no
            # pre-op; 24 of the 32 head-tower calls are dilated); in bf16 the
            # pre-op's cost (F with it against F without it)
            wc = _normal((3, 3, D, D), (9 * D) ** -0.5, g, dt)
            pre = (1.0 + _normal((B, D), 0.1, g), _normal((B, D), 0.1, g))
            xn = x.permute(0, 3, 1, 2)
            wn = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for dil in (1, 2, 4, 8):
                ms = {}
                for with_pre in (False, True):
                    args = (x, wc, pre if with_pre else None, dil, dt)
                    is_main = main and dil == 1 and not with_pre
                    lib = None
                    if main and not with_pre:
                        lib = lambda d=dil: F.conv2d(xn, wn, padding=d, dilation=d)  # noqa: E731
                    ms[with_pre], lib_ms = res.case(
                        "conv3x3", f"{shape} dilation {dil}{' pre-op' if with_pre else ''}",
                        cv.conv3x3_fused, cv.conv3x3_plain, args, dname, main=is_main,
                        library=lib, iters=10 if main else iters)
                    if lib is not None:
                        res.by_dilation("conv3x3", dil, ms[with_pre], lib_ms)
                if dname == "bfloat16":
                    log(f"conv3x3 {shape} dilation {dil} bfloat16: pre-op cost {ms[True]:.4f} /"
                        f" {ms[False]:.4f} ms = {ms[True] / ms[False]:.3f}x")
            del x, xn
    # C at ragged (B, L): problems and positions off the FAVOR+ launch's tiles,
    # and rows (P * L = 17787, 81) off the projection's and output launch's
    # 128-row blocks, one of them (L = 9) less than a block
    for B, L in ((3, 77), (1, 9)):
        x32 = _normal((B, L, L, D), 1.0, g)
        gam, bet = 1.0 + _normal((D,), 0.1, g), _normal((D,), 0.1, g)
        for dname in both:
            dt = _dt(dname)
            w = [_normal((D, HD), D ** -0.5, g, dt) for _ in range(3)]
            w += [_normal((HD, D), HD ** -0.5, g, dt), _normal((D,), 0.1, g, dt), proj]
            _performer_cases(res, x32.to(dt), gam, bet, w, f"B={B} L={L}", dname, None, False,
                             1)
    # D at rows off its 128-row blocks (5929 and 100: less than one) and on one (128)
    for shape in ((1, 77, 77), (1, 1, 100), (1, 2, 64)):
        x32 = _normal((*shape, D), 1.0, g)
        gam, bet = 1.0 + _normal((D,), 0.1, g), _normal((D,), 0.1, g)
        for dname in both:
            dt = _dt(dname)
            args = (x32.to(dt), gam, bet, _normal((D, FF), D ** -0.5, g, dt),
                    _normal((FF,), 0.1, g), _normal((FF, D), FF ** -0.5, g, dt),
                    _normal((D,), 0.1, g), 1e-5)
            res.case("fused_ff", f"rows {math.prod(shape)}", ff.fused_ln_ff_residual,
                     ff.fused_ff_plain, args, dname, iters=1)
    _wrapper_host_times(res)


def _performer_cases(res, x, gam, bet, w, shape, dname, rows, main, iters):
    """C over the row step (axis 1) and the column step, with and without
    LN/residual (LN + residual only where `rows` slices the plain version);
    at the main shape (axis 1, LN + residual) each launch's device time and
    bound."""
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp

    B, L, D = x.shape[0], x.shape[1], x.shape[-1]
    statics = (64 ** -0.25, 1e-3, 8, 64)
    for axis in (1, 2):
        for lnres in (True, False) if rows is None else (True,):
            xin = x if axis == 1 else x.reshape(B * L, L, D)
            if lnres:
                fn = (fp.fused_ln_performer_residual_axis1 if axis == 1
                      else fp.fused_ln_performer_residual)
                args = (xin, gam, bet, *w, *statics, 1e-5)

                def plain(x_, g_, b_, *rest, ax=axis):
                    return fp.performer_plain(x_, (g_, b_, rest[-1]), *rest[:-1], ax)
            else:
                fn = (fp.fused_performer_layer_axis1 if axis == 1
                      else fp.fused_performer_layer)
                args = (xin, *w, *statics)

                def plain(x_, *rest, ax=axis):
                    return fp.performer_plain(x_, None, *rest, ax)
            is_main = main and axis == 1 and lnres
            # problems: columns of the 4D x (axis 1), rows of the 3D one
            res.case("fused_performer",
                     f"{shape} axis {axis} {'LN+residual' if lnres else 'no LN'}",
                     fn, _in_rows(plain, rows, 2 if axis == 1 else 0), args, dname,
                     main=is_main, iters=10 if is_main else iters)
            if is_main:
                _performer_launches(res, lambda: fn(*args), B * L, L)


def _performer_launches(res, call, P, L):
    """C's three launches at P problems of L positions: device time a call
    (torch.profiler over 10 calls) and each launch's bound: its matrix
    products over the bf16 peak against its own inputs and outputs (the
    scratch included) over HBM."""
    M, D, HD, MF, DH, H = P * L, 288, 512, 320, 64, 8
    flops = {"proj": 2 * M * D * 3 * HD,
             "favor": P * H * (2 * 2 * L * DH * MF + 2 * 2 * L * MF * (DH + 1)),
             "out": 2 * M * HD * D}
    nbytes = {"proj": 2 * (M * D + 3 * D * HD + M * 3 * HD),
              "favor": 2 * (M * 3 * HD + MF * DH + M * HD),
              "out": 2 * (M * HD + 2 * M * D + HD * D)}
    bounds = {k: max(flops[k] / PEAK_FLOPS["bfloat16"], nbytes[k] / HBM_BYTES_S) * 1e3
              for k in flops}
    names = {"proj": "proj_wgmma_kernel", "favor": "favor_wgmma_kernel",
             "out": "out_wgmma_kernel"}
    ms = {}
    for k, name in names.items():
        ms[k] = _device_ms(call, name, calls=10)
        by = ("operations" if flops[k] / PEAK_FLOPS["bfloat16"] >= nbytes[k] / HBM_BYTES_S
              else "bytes")
        log(f"fused_performer launch {k} ({name}): {ms[k]:.4f} ms a call, bound"
            f" {bounds[k]:.4f} ms ({by})")
        require(ms[k] > 0, f"no device time for C's {k} launch in the profile")
    res.kernels["fused_performer"].update(launches_ms=ms, launch_bound_ms=bounds)


def _performer_bwd_launches(res, call, P, L):
    """C''s five launches at P problems of L positions (the row step without
    LN, bf16): device time a call (torch.profiler over 5 calls) and each
    launch's bound: the matrix products of its part of the plain backward
    over the bf16 peak against its own inputs and outputs (the scratch
    included) over HBM."""
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp

    M, D, HD, MF, DH, H = P * L, 288, 512, 320, 64, 8
    splits = fp.wgrad_splits(P, L)
    w_elems = 3 * D * HD + (HD + 1) * D
    flops = {"proj": 2 * M * D * 4 * HD,
             # s_q, s_k; ctx, num, g_phi_q, g_ctx, g_phi_k (dh + 1 wide); gq, gk, gv
             "favor": P * H * 2 * L * MF * (2 * DH + 5 * (DH + 1) + 3 * DH),
             "dx": 2 * M * 3 * HD * D,
             "wgrad": 2 * M * D * 4 * HD,
             "reduce": 0}
    nbytes = {"proj": 2 * 2 * M * D + 2 * 4 * HD * D + 2 * M * 3 * HD + 4 * M * HD,
              "favor": (2 * M * 3 * HD + 4 * M * HD + 2 * MF * DH + 2 * M * HD + 2 * M * 3 * HD
                        + 2 * (2 * M * HD + 4 * M * H)),  # gnum_ext out and back
              "dx": 2 * M * 3 * HD + 2 * D * 3 * HD + 2 * M * D,
              "wgrad": 2 * 2 * M * D + 2 * M * 3 * HD + 2 * M * HD + 4 * splits * w_elems,
              "reduce": 4 * (splits + 1) * w_elems}
    names = {"proj": "proj_wgmma_kernel", "favor": "favor_bwd_wgmma_kernel",
             "dx": "out_wgmma_kernel", "wgrad": "wgrad_wgmma_kernel",
             "reduce": "wgrad_reduce_kernel"}
    ms, bounds = {}, {}
    for k, name in names.items():
        ms[k] = _device_ms(call, name, calls=5)
        t_ops, t_bytes = flops[k] / PEAK_FLOPS["bfloat16"], nbytes[k] / HBM_BYTES_S
        bounds[k] = max(t_ops, t_bytes) * 1e3
        log(f"fused_performer_bwd launch {k} ({name}): {ms[k]:.4f} ms a call, bound"
            f" {bounds[k]:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})")
        require(ms[k] > 0, f"no device time for C''s {k} launch in the profile")
    res.kernels["fused_performer_bwd"].update(launches_ms=ms, launch_bound_ms=bounds,
                                              device_ms=sum(ms.values()))


def _ff_launch(res, call, M):
    """D's device time a call (torch.profiler over 10 calls) beside its bound:
    its two products over the bf16 peak against x, out and the weights over
    HBM."""
    D, F = 288, 1152
    t_ops = 2 * 2 * M * D * F / PEAK_FLOPS["bfloat16"]
    t_bytes = 2 * (2 * M * D + 2 * D * F) / HBM_BYTES_S
    bound_ms, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    ms = _device_ms(call, "ff_wgmma_kernel", calls=10)
    log(f"fused_ff launch (ff_wgmma_kernel): {ms:.4f} ms a call, bound {bound_ms:.4f} ms ({by})")
    require(ms > 0, "no device time for D's launch in the profile")
    res.kernels["fused_ff"].update(device_ms=ms, launch_bound_ms=bound_ms)


def _wrapper_host_times(res):
    """The C and D wrappers' host time a call at the main shape (B=4, L=128,
    bf16), the weights passed as the model passes them (transposed views of
    nn.Linear weights): the median of 5 runs of HOST_CALLS calls enqueued back
    to back on the host clock (no synchronisation inside; the card runs
    behind), beside the same calls' CUDA-event ms."""
    import torch

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import fused_ff as ff
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp

    g = torch.Generator(device="cuda").manual_seed(5)
    D, HD, FF, B, L, dt = 288, 512, 1152, 4, 128, torch.bfloat16
    x = _normal((B, L, L, D), 1.0, g, dt)
    gam, bet = 1.0 + _normal((D,), 0.1, g), _normal((D,), 0.1, g)
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 42)).cuda()
    w = [_normal((HD, D), D ** -0.5, g, dt).t() for _ in range(3)]
    w += [_normal((D, HD), HD ** -0.5, g, dt).t(), _normal((D,), 0.1, g, dt), proj]
    ff_args = (x, gam, bet, _normal((FF, D), D ** -0.5, g, dt).t(), _normal((FF,), 0.1, g),
               _normal((D, FF), FF ** -0.5, g, dt).t(), _normal((D,), 0.1, g), 1e-5)
    calls = {"fused_performer": lambda: fp.fused_ln_performer_residual_axis1(
                 x, gam, bet, *w, 64 ** -0.25, 1e-3, 8, 64, 1e-5),
             "fused_ff": lambda: ff.fused_ln_ff_residual(*ff_args)}
    with torch.inference_mode():
        for name, call in calls.items():
            runs = []
            for _ in range(5):
                call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    call()
                runs.append((time.perf_counter() - t0) * 1e3 / HOST_CALLS)
                torch.cuda.synchronize()
            host, ms = statistics.median(runs), cuda_time(call, 20)
            log(f"{name} wrapper at B=4 L=128 bfloat16: host time {host:.4f} ms a call (median"
                f" of 5 x {HOST_CALLS}; {min(runs):.4f}-{max(runs):.4f}), CUDA events"
                f" {ms:.4f} ms a call")
            res.kernels[name].update(host_ms=host, host_call_ms=ms)


def _alternating(res, name, fa, fb, turns=20, iters=10):
    """CUDA-event ms of fa and fb over `turns` alternating turns of `iters`
    calls each (a, b, b, a, ...): each side's median and range."""
    ms = {"kernel": [], "library": []}
    for i in range(turns):
        order = (("kernel", fa), ("library", fb)) if i % 2 == 0 else (("library", fb),
                                                                      ("kernel", fa))
        for side, f in order:
            ms[side].append(cuda_time(f, iters))
    summary = {side: {"median": statistics.median(v), "min": min(v), "max": max(v)}
               for side, v in ms.items()}
    log(f"{name}: {turns} alternating turns of {iters} calls, median (min-max) ms: kernel"
        f" {summary['kernel']['median']:.4f} ({summary['kernel']['min']:.4f}-"
        f"{summary['kernel']['max']:.4f}), library {summary['library']['median']:.4f}"
        f" ({summary['library']['min']:.4f}-{summary['library']['max']:.4f})")
    res.kernels[name]["turns"] = summary


def phase_backward_kernels(res):
    """3b: G, C' and F's float32 input gradient against their plain
    backward versions, float32 and bfloat16, at the training shapes."""
    import torch
    import torch.nn.functional as F

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import conv3x3 as cv
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp
    from rosettafold_tpu_torch.ops.cuda import tied_attention as ta

    g = torch.Generator(device="cuda").manual_seed(3)
    for L in (128, 250):
        for N in (8, 16):
            BH, ND = 48, N * 32
            q, k = (_normal((BH, L, ND), 0.3, g) for _ in range(2))
            v, gout = (_normal((BH, L, ND), 1.0, g) for _ in range(2))
            for dname in ("float32", "bfloat16"):
                dt = _dt(dname)
                qd, kd, vd, gd = (t.to(dt) for t in (q, k, v, gout))
                out, lse = ta.tied_attention_forward(qd, kd, vd)  # kernel A, as on the path
                args = (qd, kd, vd, out, lse, gd)
                main = (L, N, dname) == (128, 16, "bfloat16")  # train_cli's B=4, n_seq 16
                lib = None
                if main:  # SDPA's backward on the same q, k, v, where it takes the shape;
                    # autograd.grad returns the gradients and accumulates nothing
                    leaves = [t[:, None].detach().requires_grad_() for t in (qd, kd, vd)]
                    o = F.scaled_dot_product_attention(*leaves, scale=1.0)
                    lib = lambda: torch.autograd.grad(  # noqa: E731
                        o, leaves, gd[:, None], retain_graph=True)
                    try:
                        lib()
                    except RuntimeError as e:  # the yardstick only; the port never calls it
                        log(f"  SDPA backward does not take ND={ND}: {str(e)[:120]}")
                        lib = None
                res.case("tied_attention_bwd", f"B*H={BH} L={L} N={N}", ta.tied_attention_backward,
                         ta.tied_attention_bwd_plain, args, dname, main=main, library=lib,
                         iters=10 if main else 3, grad=True)
                if main and lib is not None:
                    def kernel(a=args):
                        return ta.tied_attention_backward(*a)
                    _alternating(res, "tied_attention_bwd", kernel, lib)
                    dev = {"device_ms": _device_ms(kernel),
                           "library_device_ms": _device_ms(lib)}
                    log(f"tied_attention_bwd B*H={BH} L={L} N={N} bfloat16: device time a call"
                        f" {dev['device_ms']:.4f} ms, SDPA's backward"
                        f" {dev['library_device_ms']:.4f} ms")
                    res.kernels["tied_attention_bwd"].update(dev)
    D, HD = 288, 512
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 42)).cuda()
    statics = (64 ** -0.25, 1e-3, 8, 64)
    for B, L in ((4, 128), (1, 250)):
        x32 = _normal((B, L, L, D), 1.0, g)
        gy32 = _normal((B, L, L, D), 0.05, g)
        ln = (1.0 + _normal((D,), 0.1, g), _normal((D,), 0.1, g), 1e-5)
        for dname in ("float32", "bfloat16"):
            dt = _dt(dname)
            x, gy = x32.to(dt), gy32.to(dt)
            w = [_normal((D, HD), D ** -0.5, g, dt) for _ in range(3)]
            w.append(_normal((HD, D), HD ** -0.5, g, dt))
            for axis in (1, 2):
                for with_ln in (False, True):
                    xin, gin = (x, gy) if axis == 1 else (x.reshape(B * L, L, D),
                                                           gy.reshape(B * L, L, D))
                    lnp = ln if with_ln else None

                    def kernel(x_, g_, *w_, lnp=lnp, axis=axis):
                        return fp.performer_backward(x_, lnp, *w_, proj, *statics, axis, g_)

                    def plain(x_, g_, *w_, lnp=lnp, axis=axis):
                        return fp.performer_backward(x_, lnp, *w_, proj, *statics, axis, g_,
                                                     core=fp.attn_backward_plain)
                    main = (B, L, dname, axis, with_ln) == (4, 128, "bfloat16", 1, False)
                    res.case("fused_performer_bwd",
                             f"B={B} L={L} axis {axis} {'LN+residual' if with_ln else 'no LN'}",
                             kernel, plain, (xin, gin, *w), dname, main=main,
                             iters=5 if main else 2, grad=True)
                    if main:
                        _performer_bwd_launches(res, lambda a=(xin, gin, *w): kernel(*a), B * L, L)
        for dname in ("float32", "bfloat16"):
            dt = _dt(dname)
            gc = _normal((B, L, L, D), 1.0, g, dt)
            wc = _normal((3, 3, D, D), (9 * D) ** -0.5, g, dt)
            wn = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            gn = gc.permute(0, 3, 1, 2)
            for dil in (1, 2, 4, 8):
                main_shape = (B, L, dname) == (4, 128, "bfloat16")

                def plain(g_, w_, d_):
                    return cv.conv3x3_plain(g_.to(w_.dtype), torch.flip(w_, (0, 1)).transpose(2, 3),
                                            None, d_, torch.float32)
                lib = None
                if main_shape:  # cuDNN's input gradient at each dilation, channels_last
                    lib = lambda d=dil: torch.nn.grad.conv2d_input(  # noqa: E731
                        (B, D, L, L), wn, gn, padding=d, dilation=d)
                ms, lib_ms = res.case("conv3x3_bwd", f"B={B} L={L} dilation {dil} (dx, float32 out)",
                                      cv.conv3x3_input_grad, plain, (gc, wc, dil), dname,
                                      main=main_shape and dil == 1, library=lib,
                                      iters=10 if main_shape else 3, grad=True)
                if lib is not None:
                    res.by_dilation("conv3x3_bwd", dil, ms, lib_ms)
        del x32, gy32
    _weight_grad_times(res, g)


def _weight_grad_times(res, g):
    """F's weight gradient at B=4, L=128, bf16, dilation 1 (46 a train step):
    nine products summed in float32 (JAX's dw) against the same products
    rounded to bf16 (the form it replaced), in turns: new, old, old, new."""
    import torch

    from rosettafold_tpu_torch.ops.cuda import conv3x3 as cv

    a = _normal((4, 128, 128, 288), 1.0, g, torch.bfloat16)
    gy = _normal((4, 128, 128, 288), 1.0, g, torch.bfloat16)

    def rounded():
        g2 = gy.reshape(-1, 288)
        return torch.stack([cv._shift2d(a, ki - 1, kj - 1).reshape(-1, 288).t() @ g2
                            for ki in range(3) for kj in range(3)])
    new = [cuda_time(lambda: cv.conv3x3_weight_grad(a, gy, 1), 5)]
    old = [cuda_time(rounded, 5), cuda_time(rounded, 5)]
    new.append(cuda_time(lambda: cv.conv3x3_weight_grad(a, gy, 1), 5))
    f32, b16 = statistics.mean(new), statistics.mean(old)
    log(f"conv3x3 weight gradient B=4 L=128 bfloat16: float32 sums {f32:.4f} ms, bf16-rounded"
        f" sums {b16:.4f} ms; 46 a train step: {46 * f32:.2f} against {46 * b16:.2f} ms")
    res.kernels["conv3x3_bwd"]["weight_grad_ms"] = {"float32_sums": f32, "bf16_sums": b16}


def _check_outputs(logits, xyz, plddt, B, L):
    import torch

    bins = {"theta": 37, "phi": 19, "dist": 37, "omega": 37}
    require(set(logits) == set(bins), f"logit keys {sorted(logits)}")
    for k, n in bins.items():
        require(logits[k].shape == (B, L, L, n) and logits[k].dtype == torch.float32,
                f"logits[{k}] {tuple(logits[k].shape)} {logits[k].dtype}")
        require(bool(torch.isfinite(logits[k]).all()), f"logits[{k}] not finite")
    require(xyz.shape == (B, L, 3, 3) and bool(torch.isfinite(xyz).all()), "xyz")
    require(plddt.shape == (B, L) and bool(torch.isfinite(plddt).all()), "plddt")


def _module(name):
    import importlib

    return importlib.import_module(f"rosettafold_tpu_torch.ops.cuda.{KERNELS[name].module}")


def read_counts():
    return {n: getattr(_module(n), KERNELS[n].counter) for n in KERNELS}


def zero_counts():
    for n in KERNELS:
        setattr(_module(n), KERNELS[n].counter, 0)


def _timed_forwards(model, args, n):
    import torch

    times = []
    with torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def _batch_inputs(B, N, L):
    import numpy as np
    import torch

    from rosettafold_tpu_torch.data.a3m import load_a3m, msa_features

    tokens = load_a3m(A3M)
    rows = [msa_features(np.ascontiguousarray(tokens[:, o:]), n_seq=N, crop_len=L)[0]
            for o in (0, 40, 80, 120)[:B]]
    msa = torch.as_tensor(np.concatenate(rows), device="cuda")
    aa = torch.arange(L, device="cuda")[None].repeat(B, 1)
    return msa, msa[:, 0], aa


def phase_serving():
    import torch

    from rosettafold_tpu_torch import predict as P

    model = P.build_model(P.fast_config(max(c for c, _ in REQUESTS)), device="cuda", seed=0)
    expected = dict.fromkeys(KERNELS, 0)

    def add(L, n):
        for name, spec in KERNELS.items():
            if L >= 128 or name not in PAIR_KERNELS:
                expected[name] += spec.per_fwd * n

    def check(what):
        counts = read_counts()
        require(counts == expected, f"launches {counts} != {expected} after {what}")

    readings = {}
    zero_counts()  # count only the main path from here
    norms0, in_calls = _norm_counts(), 0
    for crop, n_seq in REQUESTS:
        logits, xyz, plddt, (msa, seq, aa), fwd_s = P.predict(
            A3M, n_seq=n_seq, crop=crop, preset="fast", benchmark=True, device="cuda",
            model=model)
        L = msa.shape[-1]
        _check_outputs(logits, xyz, plddt, 1, L)
        args = [torch.as_tensor(a, device="cuda") for a in (msa, seq, aa)]
        _, times = _timed_forwards(model, args, REPS)
        add(L, 2 + REPS)
        in_calls += IN_PER_FWD * (2 + REPS) * (L >= 128)
        check(f"request L={L}")
        med = statistics.median(times)
        readings[f"request L={L} n_seq={msa.shape[1]}"] = med
        log(f"request crop={crop} L={L} n_seq={msa.shape[1]}: warm forward {fwd_s * 1e3:.2f} ms;"
            f" {REPS} more: median {med:.2f} ms, min {min(times):.2f}, max {max(times):.2f}")
    for B, N, L in BATCHES:
        args = _batch_inputs(B, N, L)
        (logits, xyz, plddt), times = _timed_forwards(model, args, 1 + REPS)
        _check_outputs(logits, xyz, plddt, B, L)
        add(L, 1 + REPS)
        in_calls += IN_PER_FWD * (1 + REPS) * (L >= 128)
        check(f"batch B={B} N={N} L={L}")
        med = statistics.median(times[1:])
        readings[f"batch B={B} N={N} L={L}"] = med
        log(f"batched forward B={B} N={N} L={L}: {REPS} warm, median {med:.2f} ms"
            f" ({B * L * L / med * 1e3:.0f} pairs/s), min {min(times[1:]):.2f},"
            f" max {max(times[1:]):.2f}")
    counts = read_counts()
    log("serving path launches: " + ", ".join(f"{n} {c}" for n, c in counts.items()))
    forwards = len(REQUESTS) * (2 + REPS) + len(BATCHES) * (1 + REPS)
    _norms_engaged("serving path", norms0, forwards, in_calls)
    return counts, model


def write_long_a3m(tmp):
    """The synthetic long-chain A3M (examples/make_demo_a3m.py's generator)."""
    from examples.make_demo_a3m import make

    path = os.path.join(tmp, "long.a3m")
    L, rows, seed = LONG_A3M
    make(path, L=L, n_seq=rows, seed=seed)
    return path


def _overflows(model):
    """The bucket overflow of each three-track block and the final block."""
    blocks = [getattr(model, f"three_track_{i}") for i in range(model.n_tt)] + [model.final_block]
    return [int(b.coord_update_with_msa_and_pair.bucket_overflow.sum()) for b in blocks]


def phase_long_serving(a3m):
    """4b: long-chain requests through predict() with the fast preset, then
    H's path (its wrapper)."""
    import torch

    from rosettafold_tpu_torch import predict as P
    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import linear_attention as la

    model = P.build_model(P.fast_config(max(c for c, _, _ in LONG_REQUESTS)), device="cuda",
                          seed=0)
    expected = dict.fromkeys(KERNELS, 0)
    zero_counts()  # count only the main path from here
    norms0 = _norm_counts()
    for crop, n_seq, reps in LONG_REQUESTS:
        logits, xyz, plddt, (msa, seq, aa), fwd_s = P.predict(
            a3m, n_seq=n_seq, crop=crop, preset="fast", benchmark=True, device="cuda",
            model=model)
        L = msa.shape[-1]
        require(P.fast_config(L).se3_impl == "bucket", f"L={L} is not on the bucket path")
        _check_outputs(logits, xyz, plddt, 1, L)
        overflow = _overflows(model)
        args = [torch.as_tensor(a, device="cuda") for a in (msa, seq, aa)]
        _, times = _timed_forwards(model, args, reps)
        for name, spec in KERNELS.items():
            expected[name] += spec.per_long_fwd * (2 + reps)
        counts = read_counts()
        require(counts == expected, f"launches {counts} != {expected} after request L={L}")
        med = statistics.median(times)
        log(f"long request crop={crop} L={L} n_seq={msa.shape[1]} (head chunk"
            f" {model.config.head_chunk if L > (model.config.head_chunk or L) else None}):"
            f" warm forward {fwd_s * 1e3:.2f} ms; {reps} more: median {med:.2f} ms,"
            f" min {min(times):.2f}, max {max(times):.2f}; bucket overflow per block"
            f" {overflow} (three-track blocks, final)")
    long_counts = read_counts()
    log("long-chain path launches: " + ", ".join(f"{n} {c}" for n, c in long_counts.items()))
    forwards = sum(2 + reps for _, _, reps in LONG_REQUESTS)
    _norms_engaged("long-chain path", norms0, forwards, IN_PER_FWD * forwards)
    profile_report(f"L={L} forward", lambda: _timed_forwards(model, args, 1))
    del model, logits, xyz, plddt
    torch.cuda.empty_cache()

    # H: on no model path; its path is the wrapper, called as a caller would
    g = torch.Generator(device="cuda").manual_seed(6)
    P_, L_ = H_SHAPE
    q, k = (_normal((P_, L_, 64), 0.1, g, torch.bfloat16) for _ in range(2))
    v = _normal((P_, L_, 64), 1.0, g, torch.bfloat16)
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 0)).cuda().bfloat16()
    zero_counts()
    with torch.inference_mode():
        for _ in range(H_PATH_CALLS):
            out = la.generalized_linear_attention(q, k, v, proj)
    torch.cuda.synchronize()
    require(out.shape == q.shape and out.dtype == q.dtype and bool(torch.isfinite(out).all()),
            "H's output")
    h_counts = read_counts()
    want = {n: H_PATH_CALLS if n == "linear_attention" else 0 for n in KERNELS}
    require(h_counts == want, f"H path launches {h_counts} != {want}")
    log(f"H path: {H_PATH_CALLS} calls of generalized_linear_attention at P={P_} L={L_} bf16")
    return {n: long_counts[n] + h_counts[n] for n in KERNELS}


def _same_weights(model, cfg):
    """RoseTTAFold(cfg) on the card with `model`'s weights (no random init).
    With a template where `model` has none, proj takes seeded template
    columns at the init's scale and ln_template the identity."""
    import torch

    from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold

    with torch.device("cuda"):
        twin = RoseTTAFold(cfg, device="cuda", init=False)
    sd = model.state_dict()
    if cfg.use_template and not model.config.use_template:
        w = sd["pair_emb.proj.weight"]
        g = torch.Generator(device="cuda").manual_seed(7)
        cols = _normal((w.shape[0], cfg.d_template), 1.0 / math.sqrt(w.shape[1] + cfg.d_template),
                       g)
        sd = {**sd, "pair_emb.proj.weight": torch.cat([w, cols], 1),
              "pair_emb.ln_template.weight": torch.ones(cfg.d_template, device="cuda"),
              "pair_emb.ln_template.bias": torch.zeros(cfg.d_template, device="cuda")}
    twin.load_state_dict(sd, strict=True)
    return twin.eval()


def _max_gap(a, b):
    """(logits max|d|, xyz max|d|) between two (logits, xyz) outputs."""
    return (max(float((a[0][k] - b[0][k]).abs().max()) for k in a[0]),
            float((a[1] - b[1]).abs().max()))


def phase_configs(long_a3m):
    """4c: the scatter SE(3) layout, the template input and long_chunk at
    flagship width (see the module docstring). Returns the kernel launches
    of its kernel-path runs."""
    import dataclasses

    import torch

    from rosettafold_tpu_torch import predict as P
    from rosettafold_tpu_torch.config import RoseTTAFoldConfig
    from rosettafold_tpu_torch.data.a3m import load_a3m, msa_features

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def counted(what, want_per_fwd, n, fn):
        """fn() with the counts at 0 before and read after; each kernel must
        have launched want_per_fwd[name] * n times."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        want = {name: want_per_fwd[name] * n for name in KERNELS}
        require(counts == want, f"launches {counts} != {want} after {what}")
        for name in KERNELS:
            total[name] += counts[name]
        return out

    long_fwd = {n: k.per_long_fwd for n, k in KERNELS.items()}
    scatter_fwd = {**long_fwd, "se3_attend_gather": 0}
    base = P.build_model(P.fast_config(CFG_CROP), device="cuda", seed=0)

    def request(model, want, tag):
        def run():
            logits, xyz, plddt, (msa, seq, aa), fwd_s = P.predict(
                long_a3m, n_seq=CFG_N_SEQ, crop=CFG_CROP, benchmark=True, device="cuda",
                model=model)
            _check_outputs(logits, xyz, plddt, 1, msa.shape[-1])
            args = [torch.as_tensor(a, device="cuda") for a in (msa, seq, aa)]
            _, times = _timed_forwards(model, args, CFG_REPS)
            return (logits, xyz), fwd_s, times, args
        out, fwd_s, times, args = counted(tag, want, 2 + CFG_REPS, run)
        med = statistics.median(times)
        log(f"{tag} crop={CFG_CROP} n_seq={CFG_N_SEQ}: warm forward {fwd_s * 1e3:.2f} ms;"
            f" {CFG_REPS} more: median {med:.2f} ms, min {min(times):.2f}, max {max(times):.2f}")
        return out, med, args

    # the scatter layout against the bucket layout, bf16 on the kernels
    bucket_out, bucket_ms, args = request(base, long_fwd, "bucket request")
    overflow = _overflows(base)
    scatter = _same_weights(base, dataclasses.replace(base.config, se3_impl="scatter"))
    scatter_out, scatter_ms, _ = request(scatter, scatter_fwd, "scatter request")
    del scatter
    d_logits, d_xyz = _max_gap(scatter_out, bucket_out)
    log(f"scatter vs bucket (bf16, L={CFG_CROP}): median {scatter_ms:.2f} / {bucket_ms:.2f} ms"
        f" ({scatter_ms / bucket_ms:.3f}x); logits max|d| {d_logits:.3e}, xyz max|d|"
        f" {d_xyz:.3e}; bucket overflow per block {overflow} (three-track blocks, final)")

    # long_chunk on the kernel path: the kernels hold no chunked intermediate
    chunked = _same_weights(base, dataclasses.replace(base.config, long_chunk=CFG_LONG_CHUNK))
    with torch.inference_mode():
        out = counted(f"long_chunk={CFG_LONG_CHUNK} fast request", long_fwd, 1,
                      lambda: chunked(*args))
    d_logits, d_xyz = _max_gap(out, bucket_out)
    log(f"long_chunk={CFG_LONG_CHUNK} on fast_config({CFG_CROP}): launches as unchunked;"
        f" logits max|d| {d_logits:.3e}, xyz max|d| {d_xyz:.3e} against the unchunked request")
    del chunked, out

    # the template input: the served bf16 kernel path (launches, finite
    # outputs), and the float32 kernel path against the float32 plain path,
    # held to the envelope. bf16 against float32 is logged beside the same
    # gap without the template: the bf16 trunk alone leaves the envelope at
    # full depth (the envelope holds float32 paths, as phase 5 does)
    L_t, n_t = CFG_TEMPLATE
    tpl_cfg = dataclasses.replace(P.fast_config(L_t), use_template=True)
    tpl_model = _same_weights(base, tpl_cfg)
    msa, seq, aa = msa_features(load_a3m(A3M), n_seq=n_t, crop_len=L_t)
    L = msa.shape[-1]
    t_args = [torch.as_tensor(a, device="cuda") for a in (msa, seq, aa)]
    g = torch.Generator(device="cuda").manual_seed(11)
    template = torch.randn(1, L, L, tpl_cfg.d_template, generator=g, device="cuda")
    per_fwd = {n: k.per_fwd for n, k in KERNELS.items()}

    def forward(model, use_template, what, kernels=True):
        args = t_args + [template] if use_template else t_args
        with torch.inference_mode():
            if not kernels:
                return model(*args)
            return counted(what, per_fwd, 1, lambda: model(*args))

    outs = {}
    for use_template in (True, False):
        cfg = dataclasses.replace(tpl_cfg, use_template=use_template)
        model = tpl_model if use_template else _same_weights(base, cfg)
        tag = f"{'template' if use_template else 'no-template'} request L={L}"
        bf16 = forward(model, use_template, tag)
        _check_outputs(*bf16, 1, L)
        plain_cfg = dataclasses.replace(cfg, compute_dtype="float32", attn_impl="xla")
        f32 = forward(_same_weights(model, plain_cfg), use_template, "", kernels=False)
        outs[use_template] = (_max_gap(bf16, f32),)
        if use_template:
            f32_k = forward(_same_weights(model, dataclasses.replace(cfg, compute_dtype="float32")),
                            True, f"template request L={L} float32")
            outs[True] += (_max_gap(f32_k, f32),)
        del model, bf16, f32
    tpl_model = None
    (b_logits, b_xyz), (d_logits, d_xyz) = outs[True]
    (n_logits, n_xyz), = outs[False]
    log(f"template request L={L} n_seq={n_t}: float32 kernels vs float32 plain: logits max|d|"
        f" {d_logits:.3e} (<= {E2E_LOGITS}), xyz max|d| {d_xyz:.3e} (<= {E2E_XYZ}); bf16"
        f" kernels vs float32 plain: logits {b_logits:.3e}, xyz {b_xyz:.3e} (without the"
        f" template: {n_logits:.3e}, {n_xyz:.3e})")
    require(d_logits <= E2E_LOGITS and d_xyz <= E2E_XYZ,
            "the template request leaves the full-depth envelope")

    # the scatter layout against the dense one, float32 plain, crop 128
    dense_cfg = dataclasses.replace(P.fast_config(CFG_DENSE_CROP), compute_dtype="float32",
                                    attn_impl="xla")
    require(dense_cfg.se3_impl == "dense", f"crop {CFG_DENSE_CROP} is not on the dense layout")
    out, logs = {}, {}
    for impl, knn_fn in (("dense", "knn_adjacency"), ("scatter", "knn_gather_indices")):
        model = _same_weights(base, dataclasses.replace(dense_cfg, se3_impl=impl))
        with NeighborLog(knn_fn) as rec:
            logits, xyz, _, _, _ = P.predict(A3M, n_seq=32, crop=CFG_DENSE_CROP, device="cuda",
                                             model=model)
        out[impl], logs[impl] = (logits, xyz), rec
        del model
    d_logits, d_xyz = _max_gap(out["scatter"], out["dense"])
    log(f"scatter vs dense f32 plain (crop {CFG_DENSE_CROP}, n_seq 32): logits max|d|"
        f" {d_logits:.3e} (<= {E2E_LOGITS}), xyz max|d| {d_xyz:.3e} (<= {E2E_XYZ})")
    _neighbor_diff("scatter vs dense", logs["scatter"], logs["dense"])
    first = [_edges(rec.calls[0][1])[0] for rec in (logs["scatter"], logs["dense"])]
    require(bool((first[0] == first[1]).all()),
            "the first three-track block's scatter and dense edge sets differ")
    require(d_logits <= E2E_LOGITS and d_xyz <= E2E_XYZ,
            f"the scatter layout leaves the full-depth envelope at crop {CFG_DENSE_CROP}")

    # long_chunk on the exact preset (float32, plain): the same result, less
    # memory. The chunks change only the shapes of the products, so the runs
    # differ in rounding, which the depth then grows (phase 5): the two-track
    # stack's outputs (where the chunked modules run) and the coordinates the
    # first three-track block takes are held to CFG_CHUNK_TOL, its edge sets
    # to equality, and the whole model, run again on the unchunked run's
    # neighborhoods (a kNN edge that flips on a rounding difference moves xyz),
    # to the full-depth envelope
    exact = _same_weights(base, RoseTTAFoldConfig(max_len=max(260, CFG_CROP)))
    del base
    res, logs, stack = {}, {}, {}
    for run in ("unchunked", "chunked", "chunked pinned"):
        model = exact if run == "unchunked" else _same_weights(
            exact, dataclasses.replace(exact.config, long_chunk=CFG_LONG_CHUNK))
        last = getattr(model, f"two_track_{model.config.n_two_track_blocks - 1}")
        hook = last.register_forward_hook(
            lambda mod, inp, out, run=run: stack.__setitem__(run, [t.clone() for t in out]))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode(), NeighborLog(
                "knn_adjacency", logs["unchunked"] if run.endswith("pinned") else None) as rec:
            t1 = time.perf_counter()
            o = model(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        hook.remove()
        res[run], logs[run] = (o[:2], torch.cuda.max_memory_allocated() / 2 ** 30, ms), rec
        del model, o, last
    exact = None
    gap = {run: _max_gap(res[run][0], res["unchunked"][0]) for run in res}
    d_stack = max(float((a - b).abs().max()) for a, b in zip(stack["chunked"], stack["unchunked"]))
    (ca_c, e_c), (ca_u, e_u) = (logs[r].calls[0] for r in ("chunked", "unchunked"))
    d_ca = float((ca_c - ca_u).abs().max())
    log(f"long_chunk={CFG_LONG_CHUNK} vs unchunked, exact preset (float32 plain, crop"
        f" {CFG_CROP}): two-track stack (msa, pair) max|d| {d_stack:.3e}, first three-track"
        f" block's CA max|d| {d_ca:.3e} (<= {CFG_CHUNK_TOL}); logits max|d|"
        f" {gap['chunked'][0]:.3e}, xyz max|d| {gap['chunked'][1]:.3e}; on the unchunked"
        f" run's neighborhoods: logits {gap['chunked pinned'][0]:.3e} (<= {E2E_LOGITS}), xyz"
        f" {gap['chunked pinned'][1]:.3e} (<= {E2E_XYZ}); peak memory {res['chunked'][1]:.2f}"
        f" / {res['unchunked'][1]:.2f} GiB; first forward {res['chunked'][2]:.2f} /"
        f" {res['unchunked'][2]:.2f} ms")
    _neighbor_diff("chunked vs unchunked", logs["chunked"], logs["unchunked"])
    require(d_stack <= CFG_CHUNK_TOL and d_ca <= CFG_CHUNK_TOL and bool((e_c == e_u).all()),
            "long_chunk changes the two-track stack's result")
    p_logits, p_xyz = gap["chunked pinned"]
    require(p_logits <= E2E_LOGITS and p_xyz <= E2E_XYZ,
            "long_chunk leaves the full-depth envelope on the same neighborhoods")
    require(res["chunked"][1] < res["unchunked"][1], "long_chunk does not lower peak memory")
    torch.cuda.empty_cache()
    log(f"phase 4c: {time.perf_counter() - t0:.1f} s; launches "
        + ", ".join(f"{n} {c}" for n, c in total.items()))
    return total


class NeighborLog:
    """Stands in for `ops.knn.<name>` (knn_adjacency on the dense layout,
    knn_bucket_indices on the bucket) while active: records each call's CA
    coordinates and output in call order (one call per block), or, given
    `replay`, returns the outputs that log recorded, in the same order."""

    def __init__(self, name, replay=None):
        self.name, self.calls, self.replay = name, [], replay

    def __enter__(self):
        from rosettafold_tpu_torch.ops import knn

        self.knn, self.real = knn, getattr(knn, self.name)
        setattr(knn, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.knn, self.name, self.real)

    def __call__(self, xyz, *args, **kw):
        out = (self.replay.calls[len(self.calls)][1] if self.replay is not None
               else self.real(xyz, *args, **kw))
        self.calls.append((xyz[:, :, 1].clone(), out))
        return out


def _edges(out):
    """(edges (B, L, L) bool, overflow or None) of a recorded output: the
    dense adjacency itself (source i, destination j), the edges of the
    scatter layout's src-major list in the same orientation, or the edges a
    bucket holds (destination j, source i) and its overflow."""
    import torch

    if isinstance(out, torch.Tensor):
        return out, None
    if len(out) == 2:  # knn_gather_indices read src-major: i -> dst_idx[b, i, s]
        dst_idx, valid = out
        B, L, _ = dst_idx.shape
        dense = torch.zeros(B, L, L + 1, dtype=torch.bool, device=dst_idx.device)
        dense.scatter_(2, torch.where(valid, dst_idx.long(), L), valid)
        return dense[..., :L], None
    src_idx, valid, overflow = out
    B, L, _ = src_idx.shape  # empty slots write to a column past the last
    dense = torch.zeros(B, L, L + 1, dtype=torch.bool, device=src_idx.device)
    dense.scatter_(2, torch.where(valid, src_idx.long(), L), valid)
    return dense[..., :L], int(overflow.sum())


def _neighbor_diff(tag, a, b):
    """Per block: how far apart the CA coordinates the two runs' neighborhoods
    were built from lie, and how many edges one run holds that the other
    does not; logged, and the edge counts returned by block."""
    blocks = []
    for i, ((ca_a, out_a), (ca_b, out_b)) in enumerate(zip(a.calls, b.calls)):
        (e_a, ov_a), (e_b, ov_b) = _edges(out_a), _edges(out_b)
        n, ca = int((e_a != e_b).sum()), float((ca_a - ca_b).abs().max())
        log(f"  {tag} block {i}: CA in max|d| {ca:.3e}"
            f" (max|CA| {float(ca_a.abs().max()):.1f}), edges in one run and not the other"
            f" {n} of {int(e_a.sum())}"
            + ("" if ov_a is None else f", overflow {ov_a} / {ov_b}"))
        blocks.append(n)
    return blocks


def phase_e2e(long_a3m):
    """5: the float32 full-depth envelope of the kernel path against the plain
    path, with each block's neighborhoods compared between the two paths.
    Where the edge sets differ, the plain path runs once more on the kernel
    path's neighborhoods, and that run is held to the envelope."""
    import dataclasses

    from rosettafold_tpu_torch import predict as P

    for a3m, crop, n_seq in ((A3M, 96, 32), (A3M, 128, 32), (long_a3m, 400, 32)):
        base = dataclasses.replace(P.fast_config(crop), compute_dtype="float32")
        knn_fn = "knn_bucket_indices" if base.se3_impl == "bucket" else "knn_adjacency"
        out, logs = {}, {}

        def run(name):
            model = P.build_model(dataclasses.replace(base, attn_impl=name.split()[0]),
                                  device="cuda", seed=0)
            with NeighborLog(knn_fn, logs["pallas"] if name == "xla pinned" else None) as rec:
                logits, xyz, _, _, _ = P.predict(a3m, n_seq=n_seq, crop=crop, device="cuda",
                                                 model=model)
            out[name], logs[name] = (logits, xyz), rec

        run("pallas")
        run("xla")
        d_logits, d_xyz = _max_gap(out["pallas"], out["xla"])
        log(f"end to end f32 kernels vs plain (crop {crop}, n_seq {n_seq}, SE(3)"
            f" {base.se3_impl}): logits max|d|"
            f" {d_logits:.3e} (<= {E2E_LOGITS}), xyz max|d| {d_xyz:.3e} (<= {E2E_XYZ});"
            f" max|xyz| {float(out['xla'][1].abs().max()):.1f}")
        flips = _neighbor_diff("kernels vs plain", logs["pallas"], logs["xla"])
        if not any(flips):
            require(d_logits <= E2E_LOGITS and d_xyz <= E2E_XYZ,
                    f"kernel path leaves the full-depth envelope at crop {crop}")
            continue
        # a near-tie of two distances flipped: the unpinned gap measures the
        # other edge set, not the kernels; hold the paths on one edge set
        run("xla pinned")
        p_logits, p_xyz = _max_gap(out["pallas"], out["xla pinned"])
        log(f"  crop {crop}: the kNN picked {sum(flips)} edges otherwise (blocks"
            f" {[i for i, n in enumerate(flips) if n]}); the plain path on the kernel path's"
            f" neighborhoods: logits max|d| {p_logits:.3e} (<= {E2E_LOGITS}), xyz max|d|"
            f" {p_xyz:.3e} (<= {E2E_XYZ})")
        _neighbor_diff("kernels vs plain pinned", logs["pallas"], logs["xla pinned"])
        require(p_logits <= E2E_LOGITS and p_xyz <= E2E_XYZ,
                f"kernel path leaves the full-depth envelope on the same neighborhoods"
                f" at crop {crop}")


def profile_report(tag, fn):
    """torch.profiler over one call of fn: device busy share and the top
    device-time operators and kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels; a record_function range (e.g. Optimizer.step) also shows a
    # device-side span, which would count its kernels twice
    on_device = [e for e in events if "CUDA" in str(e.device_type)
                 and not getattr(e, "is_user_annotation", False)]
    ops = [e for e in events if "CUDA" not in str(e.device_type)]    # host operators
    total = sum(dev(e) for e in on_device) / 1e3
    log(f"profile {tag}: wall {wall:.2f} ms, device time {total:.2f} ms,"
        f" busy {total / wall:.3f}, {sum(e.count for e in on_device)} device kernel calls")
    log("  top operators by self device time:")
    for e in sorted(ops, key=dev, reverse=True)[:12]:
        log(f"  {dev(e) / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}")
    log("  top device kernels:")
    for e in sorted(on_device, key=dev, reverse=True)[:10]:
        log(f"  {dev(e) / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}")
    for family, names in PROFILED.items():
        for name in names:
            hits = [e for e in on_device if name in e.key]
            if hits:
                ms, calls = sum(dev(e) for e in hits) / 1e3, sum(e.count for e in hits)
                log(f"  kernel {family} {name}: {ms:.2f} ms in {calls} launches,"
                    f" {ms / calls:.4f} ms a launch, {ms / max(total, 1e-9):.3f} of the"
                    f" device time")


def phase_profile(model):
    args = _batch_inputs(4, 8, 128)
    _timed_forwards(model, args, 1)
    profile_report("B=4 N=8 L=128 forward", lambda: _timed_forwards(model, args, 1))


def _backbone(L, rng):
    """(L, 3, 3) N/CA/C: a CA random walk of 3.8 A steps with inertia, N and C
    at backbone bond lengths (examples/make_demo_pairs.py's recipe)."""
    import numpy as np

    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    ca = [np.zeros(3)]
    for _ in range(L - 1):
        d = d + 0.55 * rng.normal(size=3)
        d /= np.linalg.norm(d)
        ca.append(ca[-1] + 3.8 * d)
    ca = np.stack(ca)
    xyz = np.zeros((L, 3, 3))
    xyz[:, 1] = ca
    for i in range(L):
        prev_d = ca[i] - ca[i - 1] if i > 0 else ca[i] - ca[i + 1]
        next_d = ca[i + 1] - ca[i] if i < L - 1 else ca[i] - ca[i - 1]
        prev_d = prev_d / (np.linalg.norm(prev_d) + 1e-9)
        next_d = next_d / (np.linalg.norm(next_d) + 1e-9)
        perp = np.cross(prev_d, next_d)
        if np.linalg.norm(perp) < 1e-6:
            perp = np.cross(prev_d, np.array([0.0, 0.0, 1.0]))
        perp = perp / (np.linalg.norm(perp) + 1e-9)
        xyz[i, 0] = ca[i] - 1.46 * (0.8 * prev_d + 0.6 * perp)
        xyz[i, 2] = ca[i] + 1.52 * (0.8 * next_d + 0.6 * perp)
    return xyz


def _train_pairs(tmp, n=4):
    """n (A3M, PDB) pairs in `tmp`: examples/demo_casp.a3m, each with a
    backbone of its L=250 query from a random walk of seed i. `batches`
    yields a batch only from examples of one epoch, so B=4 needs four."""
    import shutil

    import numpy as np

    from rosettafold_tpu_torch.data.a3m import load_a3m
    from rosettafold_tpu_torch.data.pdb import write_pdb

    query = load_a3m(A3M)[0]
    pairs = []
    for i in range(n):
        stem = os.path.join(tmp, f"demo{i}")
        shutil.copy(A3M, stem + ".a3m")
        write_pdb(stem + ".pdb", _backbone(len(query), np.random.default_rng(i)), query)
        pairs.append((stem + ".a3m", stem + ".pdb"))
    return pairs


def train_config(**overrides):
    """bench_train.py's kernel configuration at flagship width (L <= 384)."""
    import dataclasses

    from rosettafold_tpu_torch.config import RoseTTAFoldConfig

    cfg = RoseTTAFoldConfig(max_len=260, compute_dtype="bfloat16", attn_impl="pallas",
                            se3_impl="dense", remat=True)
    return dataclasses.replace(cfg, **overrides)


TRAIN_WARM, TRAIN_TIMED = 2, 5


def phase_training(pairs):
    """7: fit() steps at both shapes (launch counts, ms/step, peak memory,
    finite loss and grad norm), the falling loss, the float32 gradient
    envelope of the kernel path against the plain path, the step's profile."""
    import torch

    from rosettafold_tpu_torch.data.dataset import batches
    from rosettafold_tpu_torch.train import step as S
    from rosettafold_tpu_torch.train.loop import fit

    counts = dict.fromkeys(KERNELS, 0)
    state = None
    for B, N, crop in TRAIN_SHAPES:
        times, records = [], []

        def log_step(msg, times=times):
            times.append(time.perf_counter())
            records.append(msg)

        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = batches(pairs, batch_size=B, n_seq=N, crop_len=crop, seed=B)
        zero_counts()
        t0 = time.perf_counter()
        state = fit(train_config(), data, TRAIN_WARM + TRAIN_TIMED, seed=0, log_every=1,
                    moment_dtype="bfloat16", log_fn=log_step, device="cuda")
        got = read_counts()
        steps = TRAIN_WARM + TRAIN_TIMED
        want = {n: KERNELS[n].per_train_step * steps for n in KERNELS}
        require(got == want, f"train launches {got} != {want} at B={B} N={N} L={crop}")
        for n in KERNELS:
            counts[n] += got[n]
        ms = [(b - a) * 1e3 for a, b in zip([t0] + times, times)][TRAIN_WARM:]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"train B={B} n_seq={N} crop={crop}: {TRAIN_TIMED} timed steps, median"
            f" {statistics.median(ms):.2f} ms/step (min {min(ms):.2f}, max {max(ms):.2f}),"
            f" peak memory {peak:.2f} GiB")
        for r in records:
            log(f"  {r}")
            loss, grad = float(r.split("loss=")[1].split()[0]), float(r.split("grad=")[1].split()[0])
            require(math.isfinite(loss) and math.isfinite(grad), f"non-finite step: {r}")
    log("train path launches: " + ", ".join(f"{n} {c}" for n, c in counts.items()))

    # a warm B=4 step, profiled
    step_fn = S.make_train_step(state.model.config)
    batch = S.to_device(next(batches(pairs, batch_size=4, n_seq=16, crop_len=128, seed=9)),
                        "cuda")

    def one_step():
        step_fn(state, batch, 0)
        torch.cuda.synchronize()
    profile_report("train step B=4 n_seq=16 L=128", one_step)
    del state, batch

    # the loss falls on one fixed batch (tests/test_train.py:99-110)
    batch = S.to_device(next(batches(pairs, batch_size=1, n_seq=8, crop_len=128, seed=1)), "cuda")
    state = S.create_train_state(train_config(), seed=0, learning_rate=3e-4,
                                 moment_dtype="bfloat16")
    losses = []
    for _ in range(6):
        state, m = step_fn(state, batch, 7)
        losses.append(float(m["total"]))
    log("fixed-batch losses, lr 3e-4: " + " ".join(f"{v:.4f}" for v in losses))
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    del state

    # float32 gradient envelope: the same weights and batches through the kernels and the plain
    # path, at both training shapes
    envelope = {(B, N, crop): S.to_device(next(batches(pairs, batch_size=B, n_seq=N,
                                                       crop_len=crop, seed=1)), "cuda")
                for B, N, crop in TRAIN_SHAPES}
    grads, loss = {}, {}
    for impl in ("pallas", "xla"):
        model = S.create_train_state(train_config(compute_dtype="float32", p_dropout=0.0,
                                                  attn_impl=impl), seed=0).model
        for shape, env_batch in envelope.items():
            model.zero_grad(set_to_none=True)
            total, _ = S._forward_loss(model, env_batch)
            total.backward()
            loss[impl, shape] = float(total.detach())
            grads[impl, shape] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                  if p.grad is not None}
        del model
    for B, N, crop in envelope:
        shape = (B, N, crop)
        gk, gp = grads["pallas", shape], grads["xla", shape]
        require(set(gk) == set(gp), "parameters with gradients differ")
        g_k = torch.cat([t.flatten() for t in gk.values()])
        g_p = torch.cat([gp[n].flatten() for n in gk])
        cos = float(torch.nn.functional.cosine_similarity(g_k, g_p, dim=0))
        rel_norm = float((g_k.norm() - g_p.norm()).abs() / g_p.norm())
        lk, lp = loss["pallas", shape], loss["xla", shape]
        rel_loss = abs(lk - lp) / abs(lp)
        diff = {n: float((gk[n] - gp[n]).norm()) for n in gp}
        worst = max(diff, key=diff.get)  # the largest difference, against the whole gradient
        log(f"gradient envelope f32 (B={B} n_seq={N} L={crop}, dropout 0): loss {lk:.6f} vs"
            f" {lp:.6f} (rel {rel_loss:.3e} <= 1e-3), gradient cosine {cos:.7f} (>= 0.999),"
            f" rel norm diff {rel_norm:.3e} (<= 1e-2); worst tensor {worst}: |d|"
            f" {diff[worst]:.3e} = {diff[worst] / float(g_p.norm()):.3e} of the gradient's norm,"
            f" {diff[worst] / float(gp[worst].norm()):.3e} of its own")
        require(rel_loss <= 1e-3 and cos >= 0.999 and rel_norm <= 1e-2,
                f"kernel path leaves the float32 gradient envelope at B={B} n_seq={N}")
    return counts


MESH_TPS = (2, 4)  # tp degrees phase 8 splits kernels A, G, C and C' over
MESH_STEPS = 2  # fit steps of phase 8's world of one


def _shard_blocks(n, tp):
    return [(i * n // tp, (i + 1) * n // tp) for i in range(tp)]


def _split_case(res, name, tag, whole, shard, n, exact, close=()):
    """`shard(lo, hi)` on each of the tp blocks of the leading axis against
    `whole()`: the outputs listed in `exact` joined along axis 0 must equal
    the whole launch's bit for bit; those in `close` are per-shard partials
    whose sum must fall within the bf16 tolerance of phase 3b (C''s weight
    gradients). Logs and records the launches the wrapper counted for the
    whole call and for the tp shard calls together, and the times."""
    import torch

    zero_counts()
    want = whole()
    whole_launches = read_counts()[name]
    require(whole_launches > 0, f"{name} {tag}: the whole call launched no kernel")
    rec = res.kernels[name].setdefault("mesh", {"whole_ms": cuda_time(whole, 5),
                                                "whole_launches": whole_launches})
    for tp in MESH_TPS:
        blocks = _shard_blocks(n, tp)
        zero_counts()
        parts = [shard(lo, hi) for lo, hi in blocks]
        torch.cuda.synchronize()
        launches = read_counts()[name]
        require(launches == tp * whole_launches,
                f"{name} {tag}: {tp} shard calls launched {launches} times, not"
                f" {tp} x {whole_launches}")
        for i in exact:
            got = torch.cat([p[i] for p in parts])
            require(torch.equal(got, want[i]),
                    f"{name} {tag}: output {i} of {tp} shards differs from the whole launch"
                    f" (max|d| {float((got.float() - want[i].float()).abs().max()):.3e})")
        worst = 0.0
        for i in close:
            got = sum(p[i].float() for p in parts)
            ref = want[i].float()
            d = (got - ref).abs()
            bound = BF16_ATOL * max(1.0, float(ref.abs().max())) + BF16_RTOL * ref.abs()
            require(bool((d <= bound).all()),
                    f"{name} {tag}: summed partial {i} of {tp} shards outside the bf16 bound")
            worst = max(worst, float(d.max()))
        lo, hi = blocks[0]
        ms = cuda_time(lambda: shard(lo, hi), 5)
        rec[f"tp{tp}"] = {"shard_ms": ms, "shard_launches": launches,
                          "summed_max_abs_err": worst}
        log(f"mesh {name} {tag}: tp={tp}: {launches} launches over the {tp} shards"
            f" ({whole_launches} for the whole call) bit-equal to the whole call"
            f"{'' if not close else f', summed partials max|d| {worst:.3e}'};"
            f" {ms:.4f} ms a shard beside {rec['whole_ms']:.4f} ms whole")


def _world_of_one():
    """An NCCL process group of one rank on card 0, through a file store."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)


def phase_mesh(res, pairs):
    """8: (a) kernels A, G, C and C' split over tp = 2 and 4 as the tp path
    splits them (A and G by head blocks of B*H = 12 at L = 128, N = 8; C and
    C' by row problems at (B*L, L, 288) = (128, 128, 288), flagship weights),
    each shard launched alone: outputs bit-equal to one whole launch, C''s
    summed weight-gradient partials within phase 3b's bf16 bound; (b) an
    NCCL process group of one rank: parallel.dryrun, then fit through
    make_mesh(1) at the flagship config against fit without a mesh, loss and
    parameters bit-equal (a collective of one rank is the identity)."""
    import torch
    import torch.distributed as dist

    from rosettafold_tpu_torch.config import tiny_config
    from rosettafold_tpu_torch.data.dataset import batches
    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp
    from rosettafold_tpu_torch.ops.cuda import tied_attention as ta
    from rosettafold_tpu_torch.parallel import dryrun, mesh as pm
    from rosettafold_tpu_torch.train.loop import fit

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    # (a) A and G at the serving shape: B*H = 12 problems of L = 128, N*dh = 8 * 32
    q, k = (_normal((12, 128, 256), 0.3, g, bf) for _ in range(2))
    v, gout = (_normal((12, 128, 256), 1.0, g, bf) for _ in range(2))
    _split_case(res, "tied_attention", "B*H=12 L=128 N=8 bf16",
                lambda: ta.tied_attention_forward(q, k, v),
                lambda lo, hi: ta.tied_attention_forward(q[lo:hi], k[lo:hi], v[lo:hi]),
                12, exact=(0, 1))
    out, lse = ta.tied_attention_forward(q, k, v)
    _split_case(res, "tied_attention_bwd", "B*H=12 L=128 N=8 bf16",
                lambda: ta.tied_attention_backward(q, k, v, out, lse, gout),
                lambda lo, hi: ta.tied_attention_backward(q[lo:hi], k[lo:hi], v[lo:hi],
                                                          out[lo:hi], lse[lo:hi], gout[lo:hi]),
                12, exact=(0, 1, 2))
    # C and C' on the row path: 128 problems of 128 positions, D = 288
    D, HD = 288, 512
    x = _normal((128, 128, D), 1.0, g, bf)
    gy = _normal((128, 128, D), 0.05, g, bf)
    gam, bet = 1.0 + _normal((D,), 0.1, g), _normal((D,), 0.1, g)
    w = [_normal((D, HD), D ** -0.5, g, bf) for _ in range(3)]
    w += [_normal((HD, D), HD ** -0.5, g, bf), _normal((D,), 0.1, g, bf)]
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 42)).cuda()
    statics = (64 ** -0.25, 1e-3, 8, 64)

    def c_fwd(lo=0, hi=128):
        return (fp.fused_ln_performer_residual(x[lo:hi], gam, bet, *w, proj, *statics, 1e-5),)

    def c_bwd(lo=0, hi=128):
        return fp.performer_backward(x[lo:hi], (gam, bet, 1e-5), *w[:4], proj, *statics, 2,
                                     gy[lo:hi])
    _split_case(res, "fused_performer", "rows=128 L=128 LN+residual bf16",
                c_fwd, c_fwd, 128, exact=(0,))
    # dx per row bit-equal; dgamma, dbeta and the weight gradients are sums over rows
    _split_case(res, "fused_performer_bwd", "rows=128 L=128 LN bf16",
                c_bwd, c_bwd, 128, exact=(0,), close=(1, 2, 3, 4, 5, 6, 7))
    del q, k, v, gout, out, lse, x, gy
    log(f"phase 8a: {time.perf_counter() - t0:.1f} s")

    # (b) a world of one: the dry run, then fit through the mesh
    _world_of_one()
    counts = dict.fromkeys(KERNELS, 0)
    try:
        mesh = pm.make_mesh(1)
        log(f"mesh: {mesh} over NCCL ({dist.get_backend()}), world size {dist.get_world_size()}")
        r = dryrun.dryrun(tiny_config(), device="cuda", mesh=mesh)
        log(f"mesh dryrun {r['mesh']}: loss {r['metrics']['total']:.6f} grad_norm"
            f" {r['metrics']['grad_norm']:.6f}, {r['rows']} batch row(s) a rank")
        require(math.isfinite(r["metrics"]["total"]), "dryrun loss is not finite")
        runs = {}
        # cuDNN's default weight-gradient algorithms sum in a run-dependent order
        # (two mesh-free steps differed in the prediction head's proj_out
        # weights): the comparison runs both fits on deterministic algorithms
        torch.use_deterministic_algorithms(True, warn_only=True)
        for tag, kw in (("mesh", {"mesh": mesh}), ("no mesh", {})):
            times, losses = [], []

            def log_step(msg, times=times, losses=losses):
                times.append(time.perf_counter())
                losses.append(msg.split("loss=")[1].split()[0])
            data = batches(pairs, batch_size=1, n_seq=8, crop_len=128, seed=1)
            torch.cuda.synchronize()
            zero_counts()
            t1 = time.perf_counter()
            state = fit(train_config(), data, MESH_STEPS, seed=0, log_every=1,
                        moment_dtype="bfloat16", log_fn=log_step, device="cuda", **kw)
            torch.cuda.synchronize()
            got = read_counts()
            want = {n: KERNELS[n].per_train_step * MESH_STEPS for n in KERNELS}
            require(got == want, f"{tag} fit launches {got} != {want}")
            if tag == "mesh":
                for n in KERNELS:
                    counts[n] += got[n]
            ms = [(b - a) * 1e3 for a, b in zip([t1] + times, times)]
            runs[tag] = (losses, {n: p.detach().clone() for n, p in
                                  state.model.named_parameters()})
            log(f"mesh fit ({tag}) B=1 n_seq=8 crop=128: losses {' '.join(losses)}, ms/step"
                f" {' '.join(f'{t:.1f}' for t in ms)} (the first holds the model's build)")
            del state
        (l_m, p_m), (l_n, p_n) = runs["mesh"], runs["no mesh"]
        require(l_m == l_n, f"mesh fit losses {l_m} != {l_n}")
        differ = [n for n in p_n if not torch.equal(p_m[n], p_n[n])]
        require(not differ, f"mesh fit parameters differ from the mesh-free fit: {differ[:5]}")
        log(f"mesh fit: losses and all {len(p_n)} parameters bit-equal to the mesh-free fit")
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    log(f"mesh: {torch.cuda.device_count()} card(s) on this machine: a run on several cards"
        " (dp or tp > 1 over NCCL) is unverified here")
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return counts


def host_time_only():
    """`--host-time`: phases 1-2, then the C and D wrappers' host time a call
    (`_wrapper_host_times`) as one JSON line and no result line; run it from
    two checkouts to compare them."""
    phase_device()
    phase_build()
    res = Results()
    _wrapper_host_times(res)
    print(json.dumps({k: {f: res.kernels[k][f] for f in ("host_ms", "host_call_ms")}
                      for k in ("fused_performer", "fused_ff")}))
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "rosettafold_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(rosettafold_tpu_torch/ not found beside it)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card; the port's kernels run only on one",
              file=sys.stderr)
        return 2
    if "--host-time" in sys.argv[1:]:
        return host_time_only()
    res = Results()
    try:
        t0 = time.perf_counter()
        phase_device()
        phase_build()
        phase_tied(res)
        phase_se3(res)
        phase_se3_gather(res)
        phase_linear_attention(res)
        phase_pair_kernels(res)
        phase_backward_kernels(res)
        layer_norm = phase_layer_norm()
        instance_norm = phase_instance_norm()
        log(f"phases 1-3d: {time.perf_counter() - t0:.1f} s")
        serving, model = phase_serving()
        log(f"phases 1-4: {time.perf_counter() - t0:.1f} s")
        phase_profile(model)
        del model
        with tempfile.TemporaryDirectory() as tmp:
            long_a3m = write_long_a3m(tmp)
            long = phase_long_serving(long_a3m)
            log(f"phases 1-4b: {time.perf_counter() - t0:.1f} s")
            configs = phase_configs(long_a3m)
            log(f"phases 1-4c: {time.perf_counter() - t0:.1f} s")
            phase_e2e(long_a3m)
            log(f"phases 1-6: {time.perf_counter() - t0:.1f} s")
            pairs = _train_pairs(tmp)
            training = phase_training(pairs)
            log(f"phases 1-7: {time.perf_counter() - t0:.1f} s")
            mesh = phase_mesh(res, pairs)
        log(f"all phases: {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [{"name": name, "route": "cuda",
                "source": f"rosettafold_tpu_torch/csrc/{spec.source}",
                "replaces": f"rosettafold_tpu/ops/pallas/{spec.replaces}",
                "launches": serving[name] + long[name] + configs[name] + training[name]
                + mesh[name],
                "launches_serving": serving[name], "launches_long": long[name],
                "launches_configs": configs[name], "launches_training": training[name],
                "launches_mesh": mesh[name],
                **res.kernels[name]}
               for name, spec in KERNELS.items()]
    missing = [k["name"] for k in kernels if k["launches"] == 0 or "ms" not in k]
    if missing:
        print(f"chip_smoke.py: kernels without launches or times: {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels, "layer_norm": layer_norm,
                      "instance_norm": instance_norm}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
