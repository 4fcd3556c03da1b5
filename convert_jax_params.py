#!/usr/bin/env python3
"""Convert a JAX checkpoint of rosettafold_tpu into a state_dict of the PyTorch
port, for `python -m rosettafold_tpu_torch.predict --params`.

    python convert_jax_params.py --ckpt-dir ck --out params.pt [--preset full|tiny]
        [--template]

--ckpt-dir takes what `rosettafold_tpu.predict --params` takes: the directory
`rosettafold_tpu.train_cli --ckpt-dir` wrote (its TrainState under
<dir>/latest), or a checkpoint directory itself, holding a TrainState or bare
variables ({"params": ...}), with the blocks scanned (`scan_blocks`) or not,
saved by orbax or by the msgpack fallback of `rosettafold_tpu.train.checkpoint`.
--preset names the training preset the checkpoint was made with (the train
CLIs' "full" and "tiny"); --template adds the template input's parameters
(`use_template`). The port's layout is checked strictly: a missing, unexpected
or mis-shaped parameter fails the conversion.

This needs JAX, flax and orbax, so it runs where the JAX package does; the
port itself imports none of them, and the .pt file it writes is all that
`predict --params` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def restore_params(ckpt_dir: str):
    """The flax `params` tree of a checkpoint, as nested dicts of arrays."""
    from rosettafold_tpu.train.checkpoint import restore

    if os.path.isdir(os.path.join(ckpt_dir, "latest")):
        ckpt_dir = os.path.join(ckpt_dir, "latest")
    msgpack = os.path.join(ckpt_dir, "checkpoint.msgpack")
    if os.path.exists(msgpack):
        from flax import serialization

        with open(msgpack, "rb") as f:
            raw = serialization.msgpack_restore(f.read())
    else:
        raw = restore(ckpt_dir)  # orbax, read without a target structure
    if "params" not in raw:
        raise KeyError(f"{ckpt_dir}: no params in the checkpoint (keys {sorted(raw)})")
    return raw["params"]  # a TrainState's params, or bare variables' {"params": ...}


def convert(ckpt_dir: str, cfg):
    """state_dict of `rosettafold_tpu_torch.models.rosettafold.RoseTTAFold(cfg)`
    from the checkpoint at ckpt_dir."""
    from rosettafold_tpu_torch import bridge

    return bridge.state_dict_from_flax(restore_params(ckpt_dir), cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX checkpoint -> state_dict of the PyTorch port")
    p.add_argument("--ckpt-dir", required=True,
                   help="train_cli --ckpt-dir directory, or a checkpoint directory")
    p.add_argument("--out", required=True, help="output .pt (torch.save of the state_dict)")
    p.add_argument("--preset", choices=["full", "tiny"], default="full",
                   help="the training preset the checkpoint was made with")
    p.add_argument("--template", action="store_true",
                   help="the checkpoint's model takes the template input (use_template)")
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from rosettafold_tpu_torch.train_cli import preset_config

    cfg = dataclasses.replace(preset_config(args.preset, 128), use_template=args.template)
    sd = convert(args.ckpt_dir, cfg)
    torch.save(sd, args.out)
    print(f"{args.out}: {len(sd)} tensors, {sum(t.numel() for t in sd.values())} parameters")


if __name__ == "__main__":
    main()
