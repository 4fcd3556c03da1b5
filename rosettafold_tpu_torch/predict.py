"""Inference pipeline + CLI: A3M in, structure + 6D geometry out (port of
rosettafold_tpu/predict.py).

Usage:
    python -m rosettafold_tpu_torch.predict --a3m target.a3m --out out.pdb \
        [--npz out.npz] [--params state_dict.pt] [--n-seq 64] [--crop 96] \
        [--preset fast] [--device cuda]

Without --params the weights are a random init drawn from --seed. --params
takes a `torch.save`d state_dict of this port: one saved from the port's own
model, or a JAX checkpoint (`rosettafold_tpu.train_cli --ckpt-dir`) converted
by `convert_jax_params.py` at the repository's root, which runs where JAX
is. `--preset fast` serves a chain of any length on the CUDA kernels: the
dense SE(3) layout up to 384 residues, the bucketed one above (kernel B on
its gather layout), and above 1024 the row-chunked pair ResNets as well
(`fast_config`). `predict(config=...)` serves any other configuration, e.g.
the exact `se3_impl="scatter"` layout or `long_chunk`; a template input
goes to the model itself (`RoseTTAFold.forward(msa, seq, aa_idx, template)`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from .config import RoseTTAFoldConfig
from .data.a3m import load_a3m, msa_features
from .data.pdb import write_pdb
from .models.rosettafold import RoseTTAFold
from .tracing import span


def fast_config(L: int) -> RoseTTAFoldConfig:
    """The serving configuration (`--preset fast`) at sequence length L: bf16
    trunk, the hand-written kernel suite (attn_impl="pallas"), scanned-block
    seeds, dense SE(3) up to L=384 and bucketed above, head row-chunking
    above L=1024. Identical to the JAX package's `fast_config`, which tests
    pin."""
    return RoseTTAFoldConfig(
        max_len=max(260, L), compute_dtype="bfloat16", attn_impl="pallas",
        scan_blocks=True, se3_impl="dense" if L <= 384 else "bucket",
        head_chunk=512 if L > 1024 else None,
    )


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_model(cfg: RoseTTAFoldConfig, params_path: Optional[str] = None,
                device="cuda", seed: int = 0) -> RoseTTAFold:
    model = RoseTTAFold(cfg, seed=seed)
    if params_path:
        model.load_state_dict(torch.load(params_path, map_location="cpu"), strict=True)
    return model.to(device).eval()


def predict(a3m_path: str, params_path: Optional[str] = None, n_seq: int = 64,
            crop: Optional[int] = None, config: Optional[RoseTTAFoldConfig] = None,
            preset: str = "exact", benchmark: bool = False, subsample: str = "first",
            device="cuda", seed: int = 0, model: Optional[RoseTTAFold] = None):
    """Run the full pipeline.

    Returns (logits dict, xyz, plddt, (msa, seq, aa_idx), forward_s) with
    torch outputs on `device`; forward_s is the first forward's wall time, or
    with benchmark=True a second, warm forward's. preset "exact": float32 and
    plain PyTorch; "fast": `fast_config(L)`. A prebuilt `model` skips the
    build (its config then wins). Its steps are profiler spans (`tracing`)."""
    with span("rf.predict"):
        with span("rf.predict.featurize"):
            tokens = load_a3m(a3m_path)
            msa, seq, aa_idx = msa_features(tokens, n_seq=n_seq, crop_len=crop,
                                            subsample=subsample)
        L = msa.shape[-1]
        if model is None:
            if config is not None:
                cfg = config
            elif preset == "fast":
                cfg = fast_config(L)
            else:
                cfg = RoseTTAFoldConfig(max_len=max(260, L))
            with span("rf.predict.build"):
                model = build_model(cfg, params_path, device, seed)
        with span("rf.predict.to_device"):
            args = [torch.as_tensor(a, device=device) for a in (msa, seq, aa_idx)]
        with torch.inference_mode():
            _sync(device)
            for _ in range(2 if benchmark else 1):
                t0 = time.perf_counter()
                with span("rf.predict.forward"):
                    logits, xyz, plddt = model(*args)
                with span("rf.predict.sync"):
                    _sync(device)
                fwd_s = time.perf_counter() - t0
    return logits, xyz, plddt, (msa, seq, aa_idx), fwd_s


def main(argv=None):
    p = argparse.ArgumentParser(description="rosettafold_tpu_torch inference")
    p.add_argument("--a3m", required=True)
    p.add_argument("--out", required=True, help="output PDB path")
    p.add_argument("--npz", default=None, help="optional 6D-logit npz output")
    p.add_argument("--params", default=None,
                   help="state_dict .pt, e.g. from convert_jax_params.py (else random init)")
    p.add_argument("--seed", type=int, default=0, help="random-init seed")
    p.add_argument("--n-seq", type=int, default=64)
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--preset", default="exact", choices=["exact", "fast"],
                   help="exact: float32, plain PyTorch; fast: bf16 on the CUDA kernels, any L"
                        " (bucketed SE(3) above 384 residues, row-chunked head above 1024)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--benchmark", action="store_true",
                   help="run a second, warm forward and report its time")
    p.add_argument("--subsample", default="first",
                   choices=["first", "uniform", "weighted", "diversity"])
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    logits, xyz, plddt, (msa, seq, aa_idx), fwd_s = predict(
        args.a3m, args.params, args.n_seq, args.crop, preset=args.preset,
        benchmark=args.benchmark, subsample=args.subsample, device=args.device,
        seed=args.seed)
    elapsed = time.perf_counter() - t0

    plddt01 = torch.sigmoid(plddt).cpu().numpy()[0]
    write_pdb(args.out, xyz.cpu().numpy()[0], seq[0], plddt01)
    if args.npz:
        np.savez_compressed(args.npz, **{k: v.cpu().numpy()[0] for k, v in logits.items()})
    print(json.dumps({
        "a3m": args.a3m,
        "n_seq": int(msa.shape[1]),
        "L": int(msa.shape[2]),
        "device": args.device,
        "mean_plddt": float(plddt01.mean()),
        "elapsed_s": round(elapsed, 2),
        "forward_s": round(fwd_s, 3),
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
