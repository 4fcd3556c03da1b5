"""The port's mesh hooks as they behave without a mesh: identities. The
reference runs on one device and never shards."""

from __future__ import annotations


def tp_size() -> int:
    return 1


def is_local(*_params) -> bool:
    return False


def full(p):
    return p


def identity(x, *_args):
    return x


gather_tp = copy_to_tp = reduce_from_tp = shard_pair_constraint = identity


def tp_dropout(drop, x, _dim):
    return drop(x)


def tp_shard_map(fn, *args, shard=None):
    return fn(*args)
