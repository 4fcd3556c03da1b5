#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on a CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: a CUDA card is required; prints torch/CUDA versions and
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
  2. build: compiles both CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernel vs plain at the main path's shapes, TF32 off: tied attention (A)
     at L in {64, 100, 120}, N in {8, 64}, f32 and bf16, B=4; SE(3) attend
     (B) at the three GSE3Res layer shapes, L=96, B=2, kNN + band mask;
  4. serving: three requests through `predict()` with the fast preset, made
     from examples/demo_casp.a3m (crop 64 / n_seq 64, crop 96 / 32, crop 120
     / 8), then a batched forward at B=4, N=8, L=120; every forward must
     launch kernel A 21 times and kernel B 12 times;
  5. end to end: one request with the same weights through
     attn_impl="pallas" and "xla" at f32, held to the full-depth envelope
     (logits max|d| <= 1e-2, xyz <= 0.4);
then prints one JSON line of kernel results and, last, the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
A3M = os.path.join(ROOT, "examples", "demo_casp.a3m")
REQUESTS = ((64, 64), (96, 32), (120, 8))  # (crop, n_seq)
BATCH = (4, 8, 120)                        # (B, N, L)
TIED_PER_FWD, SE3_PER_FWD = 21, 12
# kernel A: float32 as tests/test_pallas.py; bf16 within two bf16 ulps of the
# plain value (both round the output, and the probabilities at other maxima)
F32_ATOL, BF16_ATOL, BF16_RTOL, SE3_TOL = 2e-5, 1e-2, 2.0 ** -6, 2e-5
E2E_LOGITS, E2E_XYZ = 1e-2, 0.4


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """Fail the run (unlike `assert`, also under python -O)."""
    if not ok:
        raise AssertionError(what)


def cuda_time(fn, iters=20, warmup=3):
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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

    for name in ("tied_attention", "se3_attend"):
        t0 = time.perf_counter()
        build.load(name)
        secs, out = build.build_log.get(name, (time.perf_counter() - t0, ""))
        log(f"build {name}: {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())


def phase_tied():
    import torch

    from rosettafold_tpu_torch.ops.cuda import tied_attention as ta

    g = torch.Generator(device="cuda").manual_seed(0)
    worst, main = 0.0, None
    for L in (64, 100, 120):
        for N in (8, 64):
            for dtype in (torch.float32, torch.bfloat16):
                BH, ND = 4 * 12, N * 32
                q, k = (torch.randn(BH, L, ND, device="cuda", generator=g) * 0.3
                        for _ in range(2))
                v = torch.randn(BH, L, ND, device="cuda", generator=g)
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                out, lse = ta.tied_attention_forward(q, k, v)
                ref, ref_lse = ta.tied_attention_plain(q, k, v)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                lse_err = float((lse - ref_lse).abs().max())
                if dtype == torch.float32:
                    atol, rtol = F32_ATOL, 0.0
                else:
                    atol, rtol = BF16_ATOL, BF16_RTOL
                ok = bool(((out.float() - ref.float()).abs()
                           <= atol + rtol * ref.float().abs()).all())
                ms = cuda_time(lambda: ta.tied_attention_forward(q, k, v))
                plain_ms = cuda_time(lambda: ta.tied_attention_plain(q, k, v))
                name = str(dtype).split(".")[-1]
                log(f"tied L={L} N={N} {name}: max|d| {err:.3e} (atol {atol} rtol {rtol})"
                    f" lse {lse_err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
                require(ok and lse_err <= 1e-4, f"tied attention disagrees at L={L} N={N} {name}")
                worst = max(worst, err)
                if (L, N, dtype) == (120, 8, torch.bfloat16):  # the batched serving shape
                    main = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": main[0], "plain_ms": main[1]}


def phase_se3():
    import torch

    from rosettafold_tpu_torch.models.rosettafold import init_like_flax
    from rosettafold_tpu_torch.models.se3 import SE3Transformer
    from rosettafold_tpu_torch.ops import knn, so3
    from rosettafold_tpu_torch.ops.cuda import se3_attend as sa

    B, L, dev = 2, 96, "cuda"
    g = torch.Generator(device="cpu").manual_seed(1)
    se3 = SE3Transformer(num_layers=2, num_channels=16, n_heads=4, num_degrees=2,
                         l0_in_features=64, l1_in_features=3, l0_out_features=32,
                         l1_out_features=3, num_edge_features=64, impl="pallas")
    init_like_flax(se3, g)
    se3 = se3.to(dev)
    xyz = torch.randn(B, L, 3, 3, generator=g).to(dev) * 8.0
    aa = torch.arange(L, device=dev)[None].repeat(B, 1)
    mask = knn.incoming_mask(knn.knn_adjacency(xyz, aa, 64)).contiguous()
    ca = xyz[:, :, 1]
    rel = ca[:, :, None, :] - ca[:, None, :, :]
    basis = {k: v.contiguous() for k, v in so3.equivariant_basis(rel, 1).items()}
    feat = torch.cat([torch.randn(B, L, L, 64, generator=g).to(dev),
                      so3.edge_radii(rel)], dim=-1).contiguous()
    worst, times = 0.0, []
    for name in ("res_0", "res_1", "res_out"):
        mod = getattr(se3, name)
        h = {d: torch.randn(B, L, m, 2 * d + 1, generator=g).to(dev)
             for d, m in mod.f_in.dict.items()}
        ck = sum((m // mod.n_heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
        qh = torch.randn(B, L, mod.n_heads * ck, generator=g).to(dev)
        with torch.no_grad():
            stacked = sa.stack_weights(mod.v, mod.k, mod.meta)
            args = (feat, basis, h, mask, qh, stacked, mod.meta)
            z = sa.gse3_attend(*args)
            ref = sa.se3_attend_plain(*args)
            torch.cuda.synchronize()
            err = max(float((z[d] - ref[d]).abs().max()) for d in ref)
            rel_ok = all(torch.allclose(z[d], ref[d], rtol=SE3_TOL, atol=SE3_TOL) for d in ref)
            ms = cuda_time(lambda: sa.gse3_attend(*args))
            plain_ms = cuda_time(lambda: sa.se3_attend_plain(*args))
        log(f"se3 {name} L={L} B={B}: max|d| {err:.3e} (rtol=atol={SE3_TOL})"
            f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        require(rel_ok, f"SE(3) attend disagrees at {name}")
        worst = max(worst, err)
        times.append((ms, plain_ms))
    return {"max_abs_err": worst, "ms": sum(t[0] for t in times) / 3,
            "plain_ms": sum(t[1] for t in times) / 3}


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


def phase_serving():
    import numpy as np
    import torch

    from rosettafold_tpu.data.a3m import load_a3m, msa_features
    from rosettafold_tpu_torch import predict as P
    from rosettafold_tpu_torch.ops.cuda import se3_attend as sa
    from rosettafold_tpu_torch.ops.cuda import tied_attention as ta

    model = P.build_model(P.fast_config(max(c for c, _ in REQUESTS)), device="cuda", seed=0)
    n_fwd = 0
    ta.launches = sa.launches = 0  # count only the main path from here
    for crop, n_seq in REQUESTS:
        logits, xyz, plddt, (msa, _, _), fwd_s = P.predict(
            A3M, n_seq=n_seq, crop=crop, preset="fast", benchmark=True, device="cuda",
            model=model)
        n_fwd += 2
        _check_outputs(logits, xyz, plddt, 1, crop)
        log(f"request crop={crop} n_seq={msa.shape[1]}: warm forward {fwd_s * 1e3:.2f} ms")
        require((ta.launches, sa.launches) == (TIED_PER_FWD * n_fwd, SE3_PER_FWD * n_fwd),
                f"launches {ta.launches}, {sa.launches} after {n_fwd} forwards")

    B, N, L = BATCH
    tokens = load_a3m(A3M)
    rows = [msa_features(np.ascontiguousarray(tokens[:, o:]), n_seq=N, crop_len=L)[0]
            for o in (0, 40, 80, 120)]
    msa = torch.as_tensor(np.concatenate(rows[:B]), device="cuda")
    aa = torch.arange(L, device="cuda")[None].repeat(B, 1)
    with torch.inference_mode():
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, xyz, plddt = model(msa, msa[:, 0], aa)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_fwd += 1
    _check_outputs(logits, xyz, plddt, B, L)
    log(f"batched forward B={B} N={N} L={L}: warm {dt * 1e3:.2f} ms")
    counts = (ta.launches, sa.launches)
    require(counts == (TIED_PER_FWD * n_fwd, SE3_PER_FWD * n_fwd),
            f"launches {counts} after {n_fwd} forwards")
    log(f"main path: {n_fwd} forwards, {counts[0]} tied-attention and {counts[1]}"
        " SE(3)-attend launches")
    return counts


def phase_e2e():
    import dataclasses

    from rosettafold_tpu_torch import predict as P

    crop, n_seq = REQUESTS[1]
    base = dataclasses.replace(P.fast_config(crop), compute_dtype="float32")
    out = {}
    for impl in ("pallas", "xla"):
        model = P.build_model(dataclasses.replace(base, attn_impl=impl), device="cuda", seed=0)
        logits, xyz, plddt, _, _ = P.predict(A3M, n_seq=n_seq, crop=crop, device="cuda",
                                             model=model)
        out[impl] = (logits, xyz)
    d_logits = max(float((out["pallas"][0][k] - out["xla"][0][k]).abs().max())
                   for k in out["xla"][0])
    d_xyz = float((out["pallas"][1] - out["xla"][1]).abs().max())
    log(f"end to end f32 kernels vs plain (crop {crop}, n_seq {n_seq}): logits max|d|"
        f" {d_logits:.3e} (<= {E2E_LOGITS}), xyz max|d| {d_xyz:.3e} (<= {E2E_XYZ})")
    require(d_logits <= E2E_LOGITS and d_xyz <= E2E_XYZ,
            "kernel path leaves the full-depth envelope")


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
    try:
        phase_device()
        phase_build()
        tied = phase_tied()
        se3 = phase_se3()
        counts = phase_serving()
        phase_e2e()
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [
        {"name": "tied_attention", "route": "cuda",
         "source": "rosettafold_tpu_torch/csrc/tied_attention.cu",
         "replaces": "rosettafold_tpu/ops/pallas/tied_attention.py:99",
         "launches": counts[0], **tied},
        {"name": "se3_attend", "route": "cuda",
         "source": "rosettafold_tpu_torch/csrc/se3_attend.cu",
         "replaces": "rosettafold_tpu/ops/pallas/se3_attend.py:486",
         "launches": counts[1], **se3},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
