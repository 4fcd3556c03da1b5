"""Wall time of the port's two host-bound paths on the card: a single request's
forward (B=1, L=120, n_seq 8, the fast preset, as chip_smoke.py's phase 4
serves it) and a train step at B=4, n_seq 16, crop 128 (bench_train's kernel
configuration at flagship width, as phase 7 trains it).

    python3 probes/host_paths.py [CHECKOUT] [--rounds R]

CHECKOUT (default: this script's checkout) is the root of the tree whose port
is measured, so one command can time two trees in turns (parent, change,
change, parent). It uses only entry points every tree of the port has
(predict.build_model, train.step). Prints the card's name and power limit,
then one JSON line: each path's wall ms, R rounds of 10 forwards and 3 train
steps after a warm-up, in turns inside the process.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("checkout", nargs="?",
                   default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args()
    root, rounds = os.path.abspath(args.checkout), args.rounds
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from rosettafold_tpu_torch import predict as P
    from rosettafold_tpu_torch.config import RoseTTAFoldConfig
    from rosettafold_tpu_torch.data.a3m import load_a3m, msa_features
    from rosettafold_tpu_torch.ops.cuda import build
    from rosettafold_tpu_torch.train import step as S

    if not torch.cuda.is_available():
        print("host_paths.py: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"tree {root}", flush=True)
    build.build_all(sorted(f.name[:-3] for f in build.CSRC.glob("*.cu")))

    # the request: the demo A3M at L=120, n_seq 8
    tokens = load_a3m(os.path.join(root, "examples", "demo_casp.a3m"))
    msa = torch.as_tensor(msa_features(tokens, n_seq=8, crop_len=120)[0], device="cuda")
    req = (msa, msa[:, 0], torch.arange(msa.shape[-1], device="cuda")[None])
    model = P.build_model(P.fast_config(250), device="cuda", seed=0)

    # the train step: B=4, n_seq 16, crop 128, residue masks that differ by row
    rng = np.random.default_rng(0)
    B, N, L = 4, 16, 128
    m = rng.integers(0, 21, (B, N, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    for b in range(B):
        mask[b, L - b - 2:] = False
    batch = S.to_device({"msa": m, "seq": m[:, 0].copy(),
                         "aa_idx": np.tile(np.arange(L, dtype=np.int32)[None], (B, 1)),
                         "xyz": (rng.normal(size=(B, L, 3, 3)) * 3.0).astype(np.float32),
                         "mask": mask}, "cuda")
    cfg = RoseTTAFoldConfig(max_len=260, compute_dtype="bfloat16", attn_impl="pallas",
                            se3_impl="dense", remat=True)
    state = S.create_train_state(cfg, 0, moment_dtype="bfloat16", device="cuda")
    step = S.make_train_step(cfg)

    def forward():
        with torch.inference_mode():
            model(*req)

    def train():
        nonlocal state
        state, metrics = step(state, batch, 0)
        float(metrics["total"])

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        wall(forward)
    for _ in range(2):
        wall(train)
    req_ms, step_ms = [], []
    for _ in range(rounds):
        req_ms += [wall(forward) for _ in range(10)]
        step_ms += [wall(train) for _ in range(3)]
    print(json.dumps({"tree": root,
                      "request_L120_ms": {"median": statistics.median(req_ms),
                                          "min": min(req_ms), "max": max(req_ms),
                                          "n": len(req_ms)},
                      "train_B4_ms": {"median": statistics.median(step_ms),
                                      "min": min(step_ms), "max": max(step_ms),
                                      "n": len(step_ms)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
