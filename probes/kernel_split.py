"""Device time of each CUDA kernel that one wrapper call of kernel E, kernel
C' or kernel H launches, on the card, by torch.profiler: a call's per-launch
split.

    python3 probes/kernel_split.py [CHECKOUT]

CHECKOUT (default: this script's checkout) is the root of the tree whose port
is measured, so one command can time two trees in turns (parent, change,
change, parent). Prints one line per kernel name and shape: ms a call (the
mean over 5 calls after one warm call), for E at (B, N, L) = (4, 8, 128) and
(1, 32, 1100), C' at B=4, L=128 (the row step without LN) and H at (P, L) =
(4096, 512) (chip_smoke.py's main shape: q, k at 0.1 std), all bfloat16.
It takes the kernels' names from the profile, so it runs on any tree of the
port, whatever its kernels are called.
"""

from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rosettafold_tpu_torch.ops import performer as favor
    from rosettafold_tpu_torch.ops.cuda import fused_performer as fp
    from rosettafold_tpu_torch.ops.cuda import linear_attention as la
    from rosettafold_tpu_torch.ops.cuda import outer_product as op

    if not torch.cuda.is_available():
        print("kernel_split.py: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"tree {root}")

    def split(tag, call, calls=5):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            ms = getattr(e, "device_time_total", 0) / 1e3 / calls
            if ms > 0:
                total += ms
                print(f"{tag}: {ms:.4f} ms a call, {e.count // calls} launches a call:"
                      f" {e.key[:100]}")
        print(f"{tag}: all kernels {total:.4f} ms a call")

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    with torch.inference_mode():
        for B, N, L in ((4, 8, 128), (1, 32, 1100)):
            x = torch.randn(B, N, L, 32, generator=g, device="cuda")
            args = (x, (x * 0.5).to(bf), torch.ones(1024, device="cuda"),
                    torch.zeros(1024, device="cuda"),
                    (torch.randn(1024, 288, generator=g, device="cuda") / 32).to(bf),
                    torch.zeros(288, device="cuda"), 1e-5, bf)
            split(f"E B={B} N={N} L={L}", lambda a=args: op.fused_outer_product_mean(*a))
    D, HD = 288, 512
    x = torch.randn(4, 128, 128, D, generator=g, device="cuda").to(bf)
    gy = (0.05 * torch.randn(4, 128, 128, D, generator=g, device="cuda")).to(bf)
    w = [(torch.randn(D, HD, generator=g, device="cuda") * D ** -0.5).to(bf) for _ in range(3)]
    w.append((torch.randn(HD, D, generator=g, device="cuda") * HD ** -0.5).to(bf))
    proj = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 42)).cuda()
    split("C' B=4 L=128 axis 1 no LN",
          lambda: fp.performer_backward(x, None, *w, proj, 64 ** -0.25, 1e-3, 8, 64, 1, gy))
    del x, gy, w
    P, L = 4096, 512
    q, k = ((torch.randn(P, L, 64, generator=g, device="cuda") * 0.1).to(bf) for _ in range(2))
    v = torch.randn(P, L, 64, generator=g, device="cuda").to(bf)
    hp = torch.from_numpy(favor.gaussian_orthogonal_matrix(320, 64, 0)).cuda().to(bf)
    with torch.inference_mode():
        split(f"H P={P} L={L}", lambda: la.generalized_linear_attention(q, k, v, hp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
