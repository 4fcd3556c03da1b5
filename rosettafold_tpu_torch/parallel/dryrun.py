"""One sharded train step at tiny shapes in an initialized world (port of
__graft_entry__.dryrun_multichip).

    RANK=r WORLD_SIZE=w DRYRUN_STORE=/shared/file python -m \\
        rosettafold_tpu_torch.parallel.dryrun [--tp T] [--device cpu|cuda] \\
        [--params sd.pt] [--batch b.npz] [--config JSON] [--fused-min-l L] \\
        [--ckpt-dir DIR] [--out result.pt]

Each of the w processes joins the process group through a file store (gloo on
cpu, NCCL on cuda; under torchrun its environment's store serves instead),
builds the ('dp', 'sp', 'tp') mesh and runs `dryrun`: one train step, the
shard shapes asserted as JAX's dry run asserts them (B/dp batch rows a rank,
to_q's out/tp rows a rank, Adam moments of the same shapes); at tp > 1
also kernels A and C split over tp by `tp_shard_map` asserted equal to the
unsplit call (at small shapes that only their plain versions take: the
CPU), then a second step with dropout on everywhere, after which the
replicated parameters must agree bit for bit across each tp group. In a
world of several ranks it also asserts that `fit` without n_devices refuses
to train (each rank would train alone). --ckpt-dir
saves the state after the first step. Rank 0 writes the result to --out: the
global batch's loss, metrics and gradient norm, the gathered gradients by
name, the split kernels' outputs and gradients, and each rank's draw from
its dropout generator.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import tiny_config
from ..models.attention import PerformerSelfAttention
from ..models.rosettafold import RoseTTAFold
from ..ops import performer as favor
from ..ops.cuda import fused_performer as fp
from ..ops.cuda.tied_attention import tied_flash_attention
from ..train import checkpoint as ckpt
from ..train import step as S
from ..train.loop import fit
from . import mesh as pm


def tiny_batch(B: int = 2, N: int = 4, L: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of B examples whose residue masks differ row by row (row b
    masks its last b + 2 residues)."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (B, N, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    for b in range(B):
        mask[b, L - b - 2:] = False
    return {"msa": msa, "seq": msa[:, 0].copy(),
            "aa_idx": np.tile(np.arange(L, dtype=np.int32)[None], (B, 1)),
            "xyz": (rng.normal(size=(B, L, 3, 3)) * 3.0).astype(np.float32), "mask": mask}


def split_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """Inputs of the split-kernel checks: kernel A's q, k, v (8, 64, 32/48)
    (tests/test_train.py:238's shapes) and kernel C's rows (16, 64, 32) with
    LN parameters and the weights of 4 heads of 8."""
    rng = np.random.default_rng(seed)
    f = np.float32
    D, HD = 32, 32
    return {"q": rng.normal(size=(8, 64, 32)).astype(f),
            "k": rng.normal(size=(8, 64, 32)).astype(f),
            "v": rng.normal(size=(8, 64, 48)).astype(f),
            "x": rng.normal(size=(16, 64, D)).astype(f),
            "gamma": (1 + 0.1 * rng.normal(size=D)).astype(f),
            "beta": (0.1 * rng.normal(size=D)).astype(f),
            "wq": (rng.normal(size=(D, HD)) * D ** -0.5).astype(f),
            "wk": (rng.normal(size=(D, HD)) * D ** -0.5).astype(f),
            "wv": (rng.normal(size=(D, HD)) * D ** -0.5).astype(f),
            "wo": (rng.normal(size=(HD, D)) * HD ** -0.5).astype(f),
            "bo": (0.1 * rng.normal(size=D)).astype(f),
            "projection": favor.gaussian_orthogonal_matrix(8, 8, seed=42).astype(f)}


SPLIT_C_STATICS = (8 ** -0.25, 1e-3, 4, 8)  # scale, kernel_eps, heads, dim_head
SPLIT_C_LN_EPS = 1e-5


def split_kernels(device) -> Dict[str, list]:
    """Kernels A and C (LN + residual) under `tp_shard_map` on
    split_inputs(): their outputs and the gradients of sum(out^2), asserted
    equal to the unsplit call (the forward bit-equal: each problem's result
    does not depend on the others)."""
    t = {k: torch.from_numpy(v).to(device) for k, v in split_inputs().items()}

    def run_a(split):
        qkv = [t[n].clone().requires_grad_() for n in "qkv"]
        fn = (lambda *a: pm.tp_shard_map(tied_flash_attention, *a)) if split \
            else tied_flash_attention
        out = fn(*qkv)
        (out ** 2).sum().backward()
        return [out.detach()] + [a.grad for a in qkv]

    def run_c(split):
        leaves = [t[n].clone().requires_grad_() for n in
                  ("x", "gamma", "beta", "wq", "wk", "wv", "wo", "bo")]

        def layer(x, *w):
            return fp.fused_ln_performer_residual(x, *w, t["projection"], *SPLIT_C_STATICS,
                                                  SPLIT_C_LN_EPS)
        out = pm.tp_shard_map(layer, *leaves, shard=(0,)) if split else layer(*leaves)
        (out ** 2).sum().backward()
        return [out.detach()] + [a.grad for a in leaves]

    result = {}
    for name, run in (("A", run_a), ("C", run_c)):
        got, want = run(True), run(False)
        assert torch.equal(got[0], want[0]), f"split kernel {name}'s forward differs"
        for i, (a, b) in enumerate(zip(got[1:], want[1:])):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=f"split kernel {name}'s gradient {i}")
        result[name] = [g.cpu() for g in got]
    return result


def _world_gather(t: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts)


def dryrun(cfg=None, batch: Optional[Dict[str, np.ndarray]] = None, *, tp: int = 1,
           seed: int = 0, device="cpu", params: Optional[Dict[str, torch.Tensor]] = None,
           fused_min_l: Optional[int] = None, ckpt_dir: Optional[str] = None,
           mesh: Optional[pm.Mesh] = None) -> Dict:
    """One sharded train step over the world's ('dp', 1, tp) mesh; see the
    module docstring for what it asserts and returns. cfg defaults to
    tiny_config(attn_impl="pallas"), batch to tiny_batch(dp) (one example a
    dp rank); params (a whole state_dict) replace the seed's weights;
    fused_min_l lowers kernel C's crossover L so tiny shapes reach it."""
    mesh = mesh or pm.make_mesh(tp=tp)
    cfg = cfg or tiny_config(attn_impl="pallas")
    refused = None
    if mesh.size > 1:
        try:
            fit(cfg, iter(()), 1, device=device)
            refused = False
        except ValueError:
            refused = True
        assert refused, "fit without n_devices trained alone in a world of several ranks"
    batch = batch if batch is not None else tiny_batch(mesh.dp)
    B = batch["msa"].shape[0]
    with pm.use_mesh(mesh):
        state = S.create_train_state(cfg, seed, device=device, mesh=mesh)
        model = state.model
        if fused_min_l is not None:
            for mod in model.modules():
                if isinstance(mod, PerformerSelfAttention):
                    mod.fused_favor_min_l = fused_min_l
        named = dict(model.named_parameters())
        if params is not None:
            model.load_state_dict({k: pm.reshard(v, pm.tp_dim(named[k]) if k in named else None)
                                   for k, v in params.items()})
        local = pm.shard_batch(mesh, batch)
        want_rows = B // mesh.dp
        assert local["msa"].shape[0] == want_rows, (local["msa"].shape, want_rows)
        with torch.device("meta"):
            whole = {n: p.shape for n, p in RoseTTAFold(cfg, init=False).named_parameters()}
        to_q = [n for n in named if n.split(".")[-2:] == ["to_q", "weight"]]
        assert to_q, "no to_q weights found"
        for n in to_q:  # out/tp rows a rank wherever the rows divide tp
            rows = whole[n][0] // mesh.tp if whole[n][0] % mesh.tp == 0 else whole[n][0]
            assert named[n].shape[0] == rows, (n, tuple(named[n].shape), tuple(whole[n]))
        step = S.make_train_step(cfg)
        batch_t = S.to_device(local, device)
        raw = {}  # the reduced gradients as the optimizer receives them (it clips in place)
        hook = state.optimizer.register_step_pre_hook(lambda *_: raw.update(
            {n: pm.unshard(p.grad, pm.tp_dim(p)).to("cpu", copy=True) for n, p in named.items()
             if p.grad is not None}))
        state, metrics = step(state, batch_t, seed)
        hook.remove()
        for p in model.parameters():  # the moments mirror the local layout
            st = state.optimizer.state.get(p, {})
            for k in ("mu", "nu"):
                if k in st:
                    assert st[k].shape == p.shape, (k, tuple(st[k].shape), tuple(p.shape))
        shards = {n: tuple(p.shape) for n, p in named.items() if pm.tp_dim(p) is not None}
        if ckpt_dir:
            ckpt.save(ckpt_dir, state)
        torch.manual_seed(S.step_seed(seed, 0, mesh.dp_rank))
        drop = torch.nn.Dropout(0.5).train()
        rng = _world_gather(torch.cat([
            torch.rand(16, device=device),
            pm.tp_dropout(drop, torch.ones(8, device=device), 0)]))
        split = None
        if mesh.tp > 1:
            split = split_kernels(device)
            # one more step with dropout on everywhere, then the replicated
            # leaves must still agree bit for bit across each tp group
            for mod in model.modules():
                if isinstance(mod, torch.nn.Dropout) and mod.p == 0.0:
                    mod.p = 0.1
            state, _ = step(state, batch_t, seed)
            for n, p in named.items():
                if pm.tp_dim(p) is None:
                    parts = pm.unshard(p.detach()[None], 0)
                    assert all(torch.equal(parts[0], q) for q in parts), f"{n} drifted across tp"
    return {"mesh": (mesh.dp, mesh.sp, mesh.tp), "rank": mesh.rank,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": raw, "shards": shards, "rows": int(local["msa"].shape[0]),
            "rng": rng.cpu(), "split": split, "alone_refused": refused}


def main(argv=None):
    p = argparse.ArgumentParser(description="one sharded train step in a torch.distributed world")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cpu")
    p.add_argument("--params", default=None, help="a whole state_dict (torch.save)")
    p.add_argument("--batch", default=None, help="an .npz of the global batch")
    p.add_argument("--config", default="{}",
                   help="JSON overrides of tiny_config(attn_impl='pallas')")
    p.add_argument("--fused-min-l", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = "nccl" if args.device == "cuda" else "gloo"
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if "DRYRUN_STORE" in os.environ:
        dist.init_process_group(backend, store=dist.FileStore(os.environ["DRYRUN_STORE"], world),
                                rank=rank, world_size=world)
    else:
        dist.init_process_group(backend)
    try:
        cfg = tiny_config(**{"attn_impl": "pallas", **json.loads(args.config)})
        batch = dict(np.load(args.batch)) if args.batch else None
        params = torch.load(args.params, weights_only=True) if args.params else None
        result = dryrun(cfg, batch, tp=args.tp, device=args.device, params=params,
                        fused_min_l=args.fused_min_l, ckpt_dir=args.ckpt_dir)
        if rank == 0:
            print(f"dryrun {result['mesh']}: loss {result['metrics']['total']:.6f} "
                  f"grad_norm {result['metrics']['grad_norm']:.6f}", flush=True)
            if args.out:
                torch.save(result, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
