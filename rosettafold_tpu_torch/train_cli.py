"""Training CLI: a directory of (A3M, PDB) pairs -> a trained checkpoint (port
of rosettafold_tpu/train_cli.py).

Usage:
    python -m rosettafold_tpu_torch.train_cli --data-dir DIR --steps 1000 \
        [--ckpt-dir ck] [--batch-size 4] [--n-seq 16] [--crop 128] \
        [--preset tiny|full] [--device cuda|cpu]

Several GPUs (data parallel over G cards; --batch-size is each node's batch,
split over its ranks):
    torchrun --nproc-per-node G -m rosettafold_tpu_torch.train_cli \
        --n-devices G --data-dir DIR ...

DIR holds matching stems: <name>.a3m + <name>.pdb. Under torchrun the process
group comes from its environment (NCCL with --device cuda, gloo with --device
cpu) and each process takes cuda:LOCAL_RANK; every node reads its own share
of the pairs (process_index = the node's rank). Tensor parallelism is
`train.loop.fit(tp=...)`, as in JAX, whose CLI has no flag for it; --sp above
1 raises (sequence parallelism is not ported).
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from .config import PerformerConfig, RoseTTAFoldConfig
from .data.dataset import batches, prefetch
from .train.loop import fit


def find_pairs(data_dir: str):
    pairs = []
    for a3m in sorted(glob.glob(os.path.join(data_dir, "*.a3m"))):
        pdb = os.path.splitext(a3m)[0] + ".pdb"
        if os.path.exists(pdb):
            pairs.append((a3m, pdb))
    if not pairs:
        raise SystemExit(f"no (a3m, pdb) pairs found in {data_dir}")
    return pairs


def preset_config(name: str, crop: int) -> RoseTTAFoldConfig:
    """The JAX CLI's presets: "tiny" and the flagship "full" (bf16, remat,
    scanned blocks: here only their shared FAVOR+ seeds)."""
    if name == "tiny":
        return RoseTTAFoldConfig(
            d_msa=96, d_pair=72, d_node=32, d_edge=32, d_state=16,
            n_two_track_blocks=1, n_three_track_blocks=2, n_encoder_layers=1,
            max_len=max(260, crop + 4), n_neighbors=(32, 32),
            performer=PerformerConfig(dim_head=16, nb_features=32),
            compute_dtype="bfloat16", remat=True,
        )
    return RoseTTAFoldConfig(max_len=max(260, crop + 4), compute_dtype="bfloat16", remat=True,
                             scan_blocks=True)


def init_distributed(device: str):
    """Under torchrun (WORLD_SIZE in the environment): the process group from
    its environment, NCCL for cuda and gloo for cpu, and cuda:LOCAL_RANK as
    this process's device. Returns (node rank, node count, whether it made
    the process group)."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, False
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return int(os.environ.get("GROUP_RANK", 0)), world // local, made


def main(argv=None):
    p = argparse.ArgumentParser(description="rosettafold_tpu_torch training")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--n-seq", type=int, default=16)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--preset", choices=["tiny", "full"], default="full")
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--subsample", choices=["uniform", "weighted", "diversity"],
                   default="uniform",
                   help="MSA row-selection strategy when alignments are deeper than --n-seq")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches to assemble ahead on a background thread (0 disables)")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = p.parse_args(argv)

    node, nodes, made_group = init_distributed(args.device)
    pairs = find_pairs(args.data_dir)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"{len(pairs)} training pairs from {args.data_dir}")
    cfg = preset_config(args.preset, args.crop)
    data = batches(pairs, batch_size=args.batch_size, n_seq=args.n_seq, crop_len=args.crop,
                   subsample=args.subsample, process_index=node, process_count=nodes)
    if args.prefetch:
        data = prefetch(data, size=args.prefetch)
    fit(cfg, data, steps=args.steps, learning_rate=args.lr, ckpt_dir=args.ckpt_dir,
        log_every=args.log_every, n_devices=args.n_devices, sp=args.sp, device=args.device)
    if made_group:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
