"""Where kernel E's bf16 time goes: variants of csrc/outer_product.cu, each with
one part of the kernel changed or cut, compiled and timed on the card.

    python3 probes/opm_variants.py

Each variant is an edited copy of the source, built with the port's nvcc
flags into cache/opm_variants/ (git-ignored) and called through its C
function at (B, N, L) = (4, 8, 128) and (1, 32, 1100), bfloat16; prints the
ptxas warnings of serialised wgmmas (C75xx), each variant's device time a
call (torch.profiler, mean over 10 or 3 calls) and whether its output equals
the unchanged kernel's. Variants:
  base     the kernel as it is;
  p1four   pass 1 takes four chunks a wgmma group instead of one;
  p2sync   pass 2 without the overlap of a chunk's op products and the last
           chunk's projection;
  noproj   pass 2 without the projection's products (wrong output);
  nopass1  without pass 1 (wrong output);
  now      W is not loaded: the products read whatever the ring holds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def variants(src):
    def cut(start, end, new=""):
        i = src.index(start)
        j = src.index(end, i)
        return src[:i] + new + src[j:]

    p1 = ("    for (int c = 0; c < NCHUNK; ++c) {\n      if (MULTI) {",
          "    // merge the lanes' statistics")
    p1four = ("    if (!MULTI) {\n      for (int c = 0; c < NCHUNK; c += 4) {\n"
              "        float d[4][32];\n        wgmma_fence();\n#pragma unroll\n"
              "        for (int q = 0; q < 4; ++q) op_mma(d[q], c + q, 0);\n"
              "        wgmma_commit();\n        wgmma_wait<0>();\n#pragma unroll\n"
              "        for (int q = 0; q < 4; ++q) stats(d[q], c + q);\n      }\n"
              "    } else {\n      for (int c = 0; c < NCHUNK; ++c) {\n"
              "        op_groups(d0, c);\n        stats(d0, c);\n      }\n    }\n")
    op_issue = ("    auto op_issue = [&](float(&d)[32], int c, int accumulate) {\n"
                "      const uint32_t xa = xs + (c >> 2) * XT, yb = ys + (c & 3) * XT;\n"
                "      wgmma_fence();\n")
    op_mma = ("    auto op_mma = [&](float(&d)[32], int c, int accumulate) {\n"
              "      const uint32_t xa = xs + (c >> 2) * XT, yb = ys + (c & 3) * XT;\n"
              "#pragma unroll\n      for (int ks = 0; ks < NKS; ++ks)\n"
              "        Wgmma<64>::ss<1, 1>(d, desc_sw128_mn(xa + ks * 2048, XT),\n"
              "                            desc_sw128_mn(yb + ks * 2048, XT),\n"
              "                            ks > 0 || accumulate);\n"
              "    };\n")
    p2 = ("      // chunk c + 1's op products run beside",
          "    } else {\n      for (int c = 0; c < NCHUNK; ++c) {\n        op_groups(d0, c);\n"
          "        normalize(")
    p2sync = ("      for (int c = 0; c < NCHUNK; ++c) {\n        op_issue(d0, c, 0);\n"
              "        wgmma_wait<0>();\n        normalize(d0, c, as + (c & 1) * A_TILE);\n"
              "        proj(c, w0 + c);\n        wgmma_wait<0>();\n        release();\n      }\n")
    proj = ("        Wgmma<144>::ss(acc0, desc_sw128(a + ks * 32), desc_sw128(w + ks * 32), 1);\n"
            "        Wgmma<144>::ss(acc1, desc_sw128(a + ks * 32),"
            " desc_sw128(w + W_HALF + ks * 32), 1);\n")
    loads = ("      tma_load_2d(dst, &w_map, bar, 64 * ld_c, 0, leader);\n"
             "      tma_load_2d(dst + W_HALF, &w_map, bar, 64 * ld_c, DP / 2, leader);\n")
    if proj not in src or loads not in src:
        raise ValueError("csrc/outer_product.cu no longer has the code the variants edit")
    return {
        "base": src,
        "p1four": cut(*p1, p1four).replace(op_issue, op_mma + op_issue),
        "p2sync": cut(*p2, p2sync),
        "noproj": src.replace(proj, ""),
        "nopass1": cut(*p1, "    (void)d0;\n"),
        "now": src.replace(loads, "").replace("mbar_arrive_expect_tx(bar, W_STAGE, leader);",
                                              "mbar_arrive_expect_tx(bar, 0, leader);"),
    }


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rosettafold_tpu_torch.ops.cuda import build
    from rosettafold_tpu_torch.ops.cuda import outer_product as op

    if not torch.cuda.is_available():
        print("opm_variants.py: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = os.path.join(ROOT, "cache", "opm_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(build.CSRC / "outer_product.cu").read()
    procs = {}
    for name, text in variants(src).items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-I",
               str(build.CSRC), "-shared", "-Xcompiler", "-fPIC", "-o",
               os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        warn = sorted({line.split(")")[0].split("(")[-1] for line in out.splitlines()
                       if "(C75" in line and "C7519" not in line})
        print(f"{name}: nvcc rc {proc.returncode}, serialised-wgmma warnings {warn or 'none'}")
        if proc.returncode == 0:
            fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")).outer_product_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fns[name] = fn
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, N, L in ((4, 8, 128), (1, 32, 1100)):
        x = torch.randn(B, N, L, 32, generator=g, device="cuda")
        y = x.bfloat16()
        gam, bet = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
        w = (torch.randn(1024, 288, generator=g, device="cuda") / 32).bfloat16()
        wt = w.t().index_select(1, op.chunk_order(w.device)).contiguous()
        bias = torch.zeros(288, device="cuda")
        out = torch.empty(B, L, L, 288, dtype=torch.bfloat16, device="cuda")
        ref = None
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                rc = fn(x.data_ptr(), y.data_ptr(), gam.data_ptr(), bet.data_ptr(),
                        wt.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N, L, 32, 288, 1e-5, 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            ref = out.clone() if name == "base" else ref
            same = bool(torch.equal(out, ref))
            calls = 10 if L <= 128 else 3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            ms = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                     if "opm_wgmma_kernel" in e.key) / 1e3 / calls
            print(f"E {name} B={B} N={N} L={L}: device {ms:.4f} ms a call, output equals base's:"
                  f" {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
