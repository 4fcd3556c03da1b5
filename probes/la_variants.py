"""Where kernel H's bf16 time goes: variants of csrc/linear_attention.cu, each
with one part of the wgmma kernel changed or cut, compiled and timed on the
card.

    python3 probes/la_variants.py

Each variant is an edited copy of the source, built with the port's nvcc
flags into cache/la_variants/ (git-ignored) and called through its C
function at (P, L) = (4096, 512), m = 320, bfloat16 (q, k at 0.1 std, as
chip_smoke.py's main shape); prints each variant's registers and spills, any
ptxas warning of serialised wgmmas (C75xx), its CUDA-event ms a call (mean of
10 calls after 2 warm ones; the variants in turns, then again in reverse
order) and the share of its outputs equal to the plain version's. Variants:
  base     the kernel as it is;
  nop2     phase 2 without its products (wrong output): phase 1's time;
  nolo     without the products of the low parts (phi and ctx as if rounded to
           bf16, kernel C's rounding points): the split's cost;
  masks    phase 1 masks the positions past L on every chunk, not only on a
           problem's last one;
  roll     phase 2's loop over feature slices not unrolled;
  ahead4, ahead3
           the K/V ring issues 4 or 3 chunks ahead (KV_AHEAD) instead of 2:
           at 4 every thread waits, at each chunk, for all warps to release
           the chunk just taken;
  pipe1, pipe2, pipe12
           phase 1, phase 2 or both software-pipelined: the feature map of the
           next 32 positions (phase 1) or features (phase 2) is issued before
           the last ones' ctx or num products, and split while they run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


PIPE1 = """      uint32_t h[2][2][4], l[2][2][4];
      const auto one = [](int) { return 1.f; };
      auto fm = [&](float(&d)[16], int hf) {
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
          Wgmma<32>::ss(d, desc_sw128(p_tile + k4 * 32), desc_sw128(kt + hf * 4096 + k4 * 32), 1);
        wgmma_commit();
      };
      auto split = [&](const float(&d)[16], int hf) {
        if (c + 1 < nc)
          favor_features_split<2>(h[hf], l[hf], d, kernel_eps, LC, t, ks, one);
        else
          favor_features_split<2>(h[hf], l[hf], d, kernel_eps, L - c * LC - 32 * hf, t, ks, one);
      };
      auto ctxw = [&](int hf) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t bv = desc_sw128_mn(vt + (2 * hf + kk) * 2048, TILE);
          Wgmma<64>::rs<1>(ctx, h[hf][kk], bv, 1);
          Wgmma<64>::rs<1>(ctx, l[hf][kk], bv, 1);
        }
        wgmma_commit();
      };
      float d[16];
      fm(d, 0);
      wgmma_wait<0>();
      split(d, 0);
      fm(d, 1);
      ctxw(0);
      wgmma_wait<1>();
      split(d, 1);
      ctxw(1);
      wgmma_wait<0>();
"""

PIPE2 = """      {
        uint32_t h[2][2][4], l[2][2][4];
        float d[16];
        auto fm = [&](int j) {
          const uint32_t ps = base + C::P_OFF + (j >> 1) * TILE + (j & 1) * 4096;
#pragma unroll
          for (int e = 0; e < 16; ++e) d[e] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            Wgmma<32>::ss(d, desc_sw128(q_tile + k4 * 32), desc_sw128(ps + k4 * 32), 1);
          wgmma_commit();
        };
        auto split = [&](int j) {
          const float* kw = ksum_s + 32 * j;
          favor_features_split<2>(h[j & 1], l[j & 1], d, kernel_eps, LC, t, dq,
                                  [kw](int col) { return kw[col]; });
        };
        auto numw = [&](int j) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t koff = (j >> 1) * TILE + (2 * (j & 1) + kk) * 32;
            const uint64_t bh = desc_sw128(base + C::HI_OFF + koff);
            const uint64_t bl = desc_sw128(base + C::LO_OFF + koff);
            Wgmma<64>::rs<0>(num, h[j & 1][kk], bh, 1);
            Wgmma<64>::rs<0>(num, h[j & 1][kk], bl, 1);
            Wgmma<64>::rs<0>(num, l[j & 1][kk], bh, 1);
          }
          wgmma_commit();
        };
        fm(0);
        wgmma_wait<0>();
        split(0);
#pragma unroll
        for (int j = 0; j < 2 * NWG; ++j) {
          if (j + 1 < 2 * NWG) fm(j + 1);
          numw(j);
          if (j + 1 < 2 * NWG) {
            wgmma_wait<1>();
            split(j + 1);
          }
        }
        wgmma_wait<0>();
      }
"""


def variants(src):
    def edit(text, old, new):
        if old not in text:
            raise ValueError(f"csrc/linear_attention.cu no longer has: {old[:60]!r}")
        return text.replace(old, new)

    def cut(text, start, end, new):
        i = text.index(start)
        return text[:i] + new + text[text.index(end, i):]

    p1 = ("#pragma unroll\n      for (int hf = 0; hf < 2; ++hf) {  // positions",
          "      __syncwarp();\n")
    p2 = ("#pragma unroll\n      for (int s = 0; s < NWG; ++s) {",
          "#pragma unroll\n      for (int hh = 0; hh < 2; ++hh) {\n        float v = dq[hh];")
    last = ("        if (c + 1 < nc)  // only a problem's last chunk holds positions past L\n"
            "          favor_features_split<2>(hi, lo, d, kernel_eps, LC, t, ks, one);\n"
            "        else\n  ")
    nolo = src
    for old in ("          Wgmma<64>::rs<1>(ctx, lo[kk], bv, 1);\n",
                "            Wgmma<64>::rs<0>(num, hi[kk], bl, 1);\n",
                "            Wgmma<64>::rs<0>(num, lo[kk], bh, 1);\n"):
        nolo = edit(nolo, old, "")
    pipe1 = cut(src, *p1, PIPE1)
    return {
        "base": src,
        "nop2": edit(src, p2[0], p2[0].replace("s < NWG", "s < 0")),
        "nolo": nolo,
        "masks": edit(src, last, ""),
        "roll": edit(src, p2[0], p2[0][len("#pragma unroll\n"):]),
        "ahead4": edit(src, "constexpr int KV_AHEAD = KV_STAGES - 2;",
                       "constexpr int KV_AHEAD = KV_STAGES;"),
        "ahead3": edit(src, "constexpr int KV_AHEAD = KV_STAGES - 2;",
                       "constexpr int KV_AHEAD = KV_STAGES - 1;"),
        "pipe1": pipe1,
        "pipe2": cut(src, *p2, PIPE2),
        "pipe12": cut(pipe1, *p2, PIPE2),
    }


def _ptxas(out):
    """registers and spills of the m = 320 kernel, and C75xx warning codes"""
    regs, entry = "", False
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = "la_wgmma_kernelILi5E" in line
        elif entry and "spill stores" in line:
            regs = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs += "; " + line.split(":", 1)[1].strip()
            entry = False
    warn = sorted({line.split(")")[0].split("(")[-1] for line in out.splitlines()
                   if "(C75" in line and "C7519" not in line})
    return regs, warn or "none"


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import build
    from rosettafold_tpu_torch.ops.cuda import linear_attention as la

    if not torch.cuda.is_available():
        print("la_variants.py: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = os.path.join(ROOT, "cache", "la_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(build.CSRC / "linear_attention.cu").read()
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
        regs, warn = _ptxas(out)
        print(f"{name}: nvcc rc {proc.returncode}; m=320 kernel: {regs}; serialised-wgmma"
              f" warnings {warn}")
        if proc.returncode == 0:
            fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")).linear_attention_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fns[name] = fn
        else:
            print(out[-3000:])
    g = torch.Generator(device="cuda").manual_seed(5)
    P, L, m = 4096, 512, 320
    q, k = ((torch.randn(P, L, 64, generator=g, device="cuda") * 0.1).bfloat16() for _ in range(2))
    v = torch.randn(P, L, 64, generator=g, device="cuda").bfloat16()
    # contiguous: the C function takes (m, 64) rows, the wrapper makes them so
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(m, 64, 0)).cuda().bfloat16()
    proj = proj.contiguous()
    with torch.inference_mode():
        ref = la.linear_attention_plain(q, k, v, proj)
        wrapped = la.generalized_linear_attention(q, k, v, proj)
    torch.cuda.synchronize()
    print(f"wrapper: max|d| {float((wrapped.float() - ref.float()).abs().max()):.3e},"
          f" bit-equal to plain {float((wrapped == ref).float().mean()):.6f}")
    outs = {name: torch.empty_like(q) for name in fns}

    def call(name):
        rc = fns[name](*(build.ptr(t) for t in (q, k, v, proj, outs[name])), P, L, 64, m, 1e-3, 1,
                       build.stream_of(q))
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def ms(name, iters=10):
        for _ in range(2):
            call(name)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            call(name)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    order = list(fns)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(ms(name))

    for name in order:
        same = torch.equal(outs[name], outs["base"]) if "base" in outs else None
        share = float((outs[name] == ref).float().mean())
        err = float((outs[name].float() - ref.float()).abs().max())
        print(f"{name}: {times[name][0]:.4f} / {times[name][1]:.4f} ms a call at P={P} L={L}"
              f" m={m}; equals base: {same}; max|d| {err:.3e}, bit-equal to plain {share:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
