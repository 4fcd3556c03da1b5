"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import dataclasses

import jax
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from rosettafold_tpu_torch import config as tconfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread for PyTorch's intra-op pool and numpy's BLAS while a port test
    module runs (autouse in every module that imports it). Tiny-width work gains
    nothing from more, and beside the suite's other parallel workers more
    threads oversubscribe the cores (an 8-core host): six tiny train steps took
    490 s instead of 12, and the SO(3) Q tables (numpy SVDs) 44 s instead of 1."""
    with threadpool_limits(limits=1):
        yield


def port_config(jcfg):
    """The port's RoseTTAFoldConfig with the fields of a JAX package one."""
    fields = dataclasses.asdict(jcfg)
    fields["performer"] = tconfig.PerformerConfig(**fields["performer"])
    return tconfig.RoseTTAFoldConfig(**fields)


def random_params(jmod, *args, seed=0):
    """jmod's parameter tree (from its abstract init, no compile) filled with
    numpy draws at flax-like scales. Biases and norm shifts are non-zero, so a
    mis-mapped bias cannot hide behind flax's zero init."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "embedding":
            std = 1.0 / np.sqrt(s.shape[-1])
        elif leaf.startswith("W_"):
            std = 1.0 / np.sqrt(s.shape[-1])
        elif leaf == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        else:  # bias, bias_d
            std = 0.1
        return (rng.normal(size=s.shape) * std).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)
