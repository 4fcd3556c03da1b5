"""Device mesh, sharding layout and every collective of the port (port of
rosettafold_tpu/parallel/mesh.py over torch.distributed, one process a GPU).

The mesh is JAX's ('dp', 'sp', 'tp'), laid over the world's ranks row-major
(rank = (d * sp + s) * tp + t, JAX's reshape of the device list):

  * 'dp'  data parallel: each rank takes its block of the batch rows
          (shard_batch); the loss divides by global denominators and the
          gradients are summed over the ranks (reduce_gradients).
  * 'sp'  sequence parallel over MSA rows and the pair track's first L axis:
          not ported (ROADMAP queue 1, item 6b); sp > 1 raises.
  * 'tp'  tensor parallel (Megatron): the leaves the name rules match
          (_TP_COL: output axis, _TP_ROW: input axis) hold 1/tp of their
          axis on each rank (shard_params). The attention and feed-forward
          layers compute on their local heads / hidden units and all-reduce
          once at the row-parallel product; every other use of a sharded
          leaf gathers it (`full`), the same math as the unsharded layer,
          which is all XLA's layout hint gives in JAX.

JAX's XLA inserts the collectives; here each is written out, as an autograd
Function whose backward is the transposed collective, and all of them live in
this module. The model reads the mesh that `use_mesh` makes current (JAX's
`set_mesh`); with none current every helper is the identity, so the
single-device path is unchanged.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

SP_TODO = ("sequence parallelism (sp > 1) is not ported: ROADMAP queue 1, item 6b")

# Megatron-style tensor parallelism, JAX's rules: modules whose OUTPUT axis
# stacks heads / FF hidden units shard it; their down-projections shard their
# INPUT axis (row-parallel). Applied to the port's state_dict names, which
# follow the flax tree: the module name is [-2]; `weight` of rank >= 2 is
# flax's Dense / Conv `kernel` (bridge.py), so flax's output axis (last) is
# the torch weight's dim 0 and its input axis (second to last) dim 1; a bias
# follows its weight's output axis.
_TP_COL = frozenset({"to_q", "to_k", "to_v", "fc1", "msa2value"})
_TP_ROW = frozenset({"to_out", "fc2"})


def tp_rule(name: str, shape, tp: int) -> Optional[int]:
    """The dim of the leaf `name` (a state_dict key) that shards over a tp
    group of `tp` ranks, or None: replicated, also when the axis does not
    divide tp (JAX's `_tp_spec`)."""
    parts = name.split(".")
    if len(parts) < 2 or tp == 1:
        return None
    mod, kind = parts[-2], parts[-1]
    nd = len(shape)
    kernel = kind == "weight" and nd >= 2
    if mod in _TP_COL and (kernel or kind == "bias") and nd >= 1 and shape[0] % tp == 0:
        return 0
    if mod in _TP_ROW and kernel and shape[1] % tp == 0:
        return 1
    return None


class Mesh:
    """The ('dp', 'sp', 'tp') mesh over an initialized process group: its
    sizes, this rank's coordinates and the process groups of its axes."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.dp, self.sp, self.tp = device_mesh.mesh.shape
        self.dp_rank = device_mesh.get_local_rank("dp")
        self.tp_rank = device_mesh.get_local_rank("tp")
        self.dp_group = device_mesh.get_group("dp")
        self.tp_group = device_mesh.get_group("tp")
        self.size = self.dp * self.sp * self.tp
        self.rank = dist.get_rank()
        # the dp coordinates on this rank's host: a host feeds its own batch
        # (data.dataset.batches with process_index = the node's rank)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", self.size))
        self.dp_per_host = max(1, local // (self.sp * self.tp))

    def __repr__(self):
        return f"Mesh(dp={self.dp}, sp={self.sp}, tp={self.tp})"


def make_mesh(n_devices: Optional[int] = None, sp: int = 1, tp: int = 1) -> Mesh:
    """The ('dp', 'sp', 'tp') mesh over the world of the initialized process
    group (JAX's make_mesh over its devices). n_devices, where given, must be
    the world size: one process a device, launched by torchrun."""
    if sp > 1:
        raise NotImplementedError(SP_TODO)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {n_devices or '?'} devices needs an initialized process group: "
            "launch one process a GPU under torchrun (train_cli does "
            "init_process_group from its environment)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices {n_devices} != world size {n}: launch "
                         f"torchrun with {n_devices} processes")
    assert n % (sp * tp) == 0, f"n_devices {n} not divisible by sp*tp {sp * tp}"
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, (n // (sp * tp), sp, tp),
                                 mesh_dim_names=("dp", "sp", "tp")))


_current: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the one the model's layers read (JAX's set_mesh)."""
    global _current
    prev, _current = _current, mesh
    try:
        yield mesh
    finally:
        _current = prev


def current() -> Optional[Mesh]:
    return _current


def tp_size() -> int:
    return 1 if _current is None else _current.tp


def dp_size() -> int:
    return 1 if _current is None else _current.dp


def shard_pair_constraint(pair):
    """The pair tensor's sp layout: the identity without sp, as in JAX."""
    if _current is not None and _current.sp > 1:
        raise NotImplementedError(SP_TODO)
    return pair


# ---- the batch --------------------------------------------------------------

def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's rows of a host batch (every array's axis 0): the host's
    batch splits into one block per dp coordinate on the host; the ranks of
    one tp group take the same rows (JAX's P('dp', ...))."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        assert B % mesh.dp_per_host == 0, (
            f"{k}: batch {B} not divisible by the host's {mesh.dp_per_host} dp ranks")
        n = B // mesh.dp_per_host
        i = mesh.dp_rank % mesh.dp_per_host
        out[k] = v[i * n:(i + 1) * n]
    return out


# ---- parameters -------------------------------------------------------------

def _block(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def shard_params(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Keep this rank's block of each leaf the tp rules shard, in place; mark
    the parameter with `tp_dim`. Every rank built the same full model from
    one seed. Create the optimizer after this: its moments then take the
    local shapes. Returns {name: dim} of the sharded leaves."""
    sharded = {}
    if mesh.tp == 1:
        return sharded
    for name, p in model.named_parameters():
        d = tp_rule(name, p.shape, mesh.tp)
        if d is not None:
            p.data = _block(p.data, d, mesh.tp_rank, mesh.tp).clone()
            p.tp_dim = d
            sharded[name] = d
    return sharded


def tp_dim(p) -> Optional[int]:
    """The dim a parameter is sharded along under the current mesh, or None."""
    return getattr(p, "tp_dim", None)


def is_local(*params) -> bool:
    """All of `params` are tp shards: the layer can compute on its own
    block (Megatron) instead of gathering them."""
    return _current is not None and _current.tp > 1 and all(
        tp_dim(p) is not None for p in params)


# ---- collectives, each with its transposed collective as backward -----------

def _all_gather(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # gloo moves bytes
    parts = [torch.empty_like(raw) for _ in range(size)]
    dist.all_gather(parts, raw, group=group)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bfloat16) if t.dtype == torch.bfloat16 else out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over tp; backward: this rank's block (the
    gathered tensor feeds replicated compute, so its gradient is the same
    on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh.tp_group, mesh.tp)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _block(g, ctx.dim, m.tp_rank, m.tp).contiguous(), None, None


class _Split(torch.autograd.Function):
    """This rank's block along `dim`; backward: all-gather of the blocks'
    gradients."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _block(x, dim, mesh.tp_rank, mesh.tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _all_gather(g, ctx.dim, m.tp_group, m.tp), None, None


class _Copy(torch.autograd.Function):
    """Identity into a tp-parallel region; backward: all-reduce over tp (each
    rank's region gives a partial gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.tp_group), None


class _Reduce(torch.autograd.Function):
    """All-reduce over tp out of a tp-parallel region (the row-parallel
    product's partial sums); backward: the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim, _current)


def split_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Split.apply(x, dim, _current)


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x, _current)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, _current)


def full(p):
    """The whole of parameter `p`: its all-gather over tp where it is a
    shard (backward: this rank's block of the gradient), else `p` itself."""
    if _current is None or _current.tp == 1 or p is None or tp_dim(p) is None:
        return p
    return gather_tp(p, p.tp_dim)


def tp_dropout(drop: torch.nn.Dropout, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Dropout on a tp-local block of a tensor (local heads or hidden units
    along `dim`). Every rank of the tp group draws the mask of the whole
    tensor from the generator they share and keeps its own block, so the
    blocks are independent (JAX draws one mask over the global array) while
    the shared generator stays in step for the replicated activations."""
    if not drop.training or drop.p == 0.0 or tp_size() == 1:
        return drop(x)
    m, p = _current, drop.p
    shape = list(x.shape)
    shape[dim] *= m.tp
    keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p)
    return x * _block(keep, dim, m.tp_rank, m.tp) / (1.0 - p)


def tp_shard_map(fn, *args, shard: Optional[Iterable[int]] = None):
    """fn(*args) with the leading axis of the `shard` args (default: all)
    split into contiguous blocks over tp, and its outputs all-gathered along
    axis 0 (JAX's tp_shard_map around an opaque kernel). The other tensor
    args, e.g. whole-layer weights, are replicated in the group: their
    gradients are per-block partials, summed over tp in the backward. A plain
    call without a mesh, at tp == 1, or when a split axis does not divide tp."""
    m = _current
    shard = set(range(len(args))) if shard is None else set(shard)
    if m is None or m.tp == 1 or any(args[i].shape[0] % m.tp for i in shard):
        return fn(*args)
    local = []
    for i, a in enumerate(args):
        if i in shard:
            a = split_tp(a, 0)
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            a = copy_to_tp(a)
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(gather_tp(o, 0) for o in out)
    return gather_tp(out, 0)


# ---- data-parallel sums and the gradient reduction ---------------------------

def dp_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of a tensor over the dp ranks, outside autograd (the loss's global
    denominators, the metrics); the identity without a mesh."""
    if _current is None:
        return t
    return _all_reduce(t.detach(), _current.dp_group)


def tp_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the tp group, outside autograd (the sharded leaves' share of
    the gradient norm); the identity without a mesh."""
    if _current is None:
        return t
    return _all_reduce(t.detach(), _current.tp_group)


def _reduce_flat(grads, group, scale=None):
    if not grads:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.div_(scale)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


@torch.no_grad()
def reduce_gradients(params) -> None:
    """The global batch's gradient on every rank, in place. A sharded leaf's
    gradient sums over dp. A replicated leaf's sums over the whole world and
    divides by tp: the tp ranks hold the same gradient, and averaging them in
    one all-reduce keeps them bit-equal, so the replicated parameters never
    drift apart across a tp group."""
    m = _current
    if m is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    sharded = [p.grad for p in params if p.grad is not None and tp_dim(p) is not None]
    ids = {id(g) for g in sharded}
    _reduce_flat(sharded, m.dp_group)
    _reduce_flat([g for g in grads if id(g) not in ids], None, m.tp if m.tp > 1 else None)


def barrier() -> None:
    if _current is not None:
        dist.barrier()


# ---- whole tensors for checkpoints -------------------------------------------

@torch.no_grad()
def unshard(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The whole leaf of which `t` is this rank's block (dim None: t)."""
    if dim is None or _current is None or _current.tp == 1:
        return t
    return _all_gather(t, dim, _current.tp_group, _current.tp)


def reshard(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """This rank's block of a whole leaf (dim None: t)."""
    if dim is None or _current is None or _current.tp == 1:
        return t
    return _block(t, dim, _current.tp_rank, _current.tp).clone()


def world_size() -> int:
    """The initialized process group's world size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the current mesh (0 without one)."""
    return 0 if _current is None else _current.rank

