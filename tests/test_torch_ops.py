"""The PyTorch port's ops against the JAX package: host constants bit-equal,
device math at float32 tolerance, the serving-config pin, and the port's
freedom from jax."""

import dataclasses
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rosettafold_tpu import predict as jpredict
from rosettafold_tpu.ops import knn as jknn
from rosettafold_tpu.ops import performer as jfavor
from rosettafold_tpu.ops import so3 as jso3
from rosettafold_tpu.ops.sinusoidal import sinusoidal_table as j_sinusoidal_table
from rosettafold_tpu_torch import predict as tpredict
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops import performer as tfavor
from rosettafold_tpu_torch.ops import so3 as tso3
from rosettafold_tpu_torch.ops.sinusoidal import sinusoidal_table as t_sinusoidal_table

ATOL = 1e-5


def test_port_imports_no_jax():
    """Every module of the port imports with jax absent from sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import rosettafold_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "flax")))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("L", [16, 96, 127, 128, 400, 1500])
def test_fast_config_pinned_to_jax(L):
    assert dataclasses.asdict(tpredict.fast_config(L)) == dataclasses.asdict(
        jpredict.fast_config(L))


@pytest.mark.parametrize("seed", [42, 43, 142, 1042, 1143, 9042])
def test_projection_bit_equal(seed):
    a = tfavor.gaussian_orthogonal_matrix(320, 64, seed)
    b = jfavor.gaussian_orthogonal_matrix(320, 64, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_q_tables_bit_equal():
    for J_in in range(3):
        for J_out in range(3):
            for J in range(abs(J_in - J_out), J_in + J_out + 1):
                a = tso3.basis_transformation_Q_J(J, J_in, J_out)
                b = jso3.basis_transformation_Q_J(J, J_in, J_out)
                assert np.array_equal(a, b), (J, J_in, J_out)


def test_sinusoidal_table():
    np.testing.assert_array_equal(t_sinusoidal_table(50, 24).numpy(),
                                  np.asarray(j_sinusoidal_table(50, 24)))


@pytest.mark.parametrize("L", [8, 40])  # quadratic and linear associations
def test_favor_parity(L):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 3, L, 16)).astype(np.float32) for _ in range(3))
    proj = jfavor.gaussian_orthogonal_matrix(24, 16, 7)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, proj))
    for is_query in (True, False):
        np.testing.assert_allclose(
            tfavor.softmax_kernel_features(tq, tp, is_query=is_query).numpy(),
            np.asarray(jfavor.softmax_kernel_features(q, proj, is_query=is_query)),
            atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        tfavor.generalized_kernel_features(tq, tp).numpy(),
        np.asarray(jfavor.generalized_kernel_features(q, proj)), atol=ATOL, rtol=1e-5)
    for generalized in (True, False):
        np.testing.assert_allclose(
            tfavor.favor_attention(tq, tk, tv, tp, generalized=generalized).numpy(),
            np.asarray(jfavor.favor_attention(q, k, v, proj, generalized=generalized)),
            atol=ATOL, rtol=1e-4)


def test_spherical_harmonics_and_basis_parity():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(2, 7, 7, 3)).astype(np.float32) * 3.0
    td = torch.from_numpy(d)
    r_t, a_t, b_t = tso3.spherical_from_cartesian(td)
    r_j, a_j, b_j = jso3.spherical_from_cartesian(jnp.asarray(d))
    for x, y in ((r_t, r_j), (a_t, a_j), (b_t, b_j)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL)
    sh_t = tso3.precompute_sh(a_t, b_t, 2)
    sh_j = jso3.precompute_sh(a_j, b_j, 2)
    for J in sh_j:
        np.testing.assert_allclose(sh_t[J].numpy(), np.asarray(sh_j[J]), atol=ATOL)
    bt = tso3.equivariant_basis(td, 1)
    bj = jso3.equivariant_basis(jnp.asarray(d), 1)
    assert set(bt) == set(bj)
    for key in bj:
        np.testing.assert_allclose(bt[key].numpy(), np.asarray(bj[key]), atol=ATOL)
    np.testing.assert_allclose(tso3.edge_radii(td).numpy(),
                               np.asarray(jso3.edge_radii(jnp.asarray(d))), atol=ATOL)


@pytest.mark.parametrize("K", [4, 8, 30, "tie"])
def test_knn_parity_with_a_tie(K):
    rng = np.random.default_rng(2)
    L = 20
    # integer coordinates: distances are exact, so equal ones tie exactly
    xyz = np.round(rng.normal(size=(1, L, 3, 3)) * 4.0).astype(np.float32)
    # residue 5 equidistant from residues 3 and 7: one tied distance
    xyz[:, 7, 1] = 2 * xyz[:, 5, 1] - xyz[:, 3, 1]
    # spaced numbering: the sequence band holds no neighbor, so the tie decides
    aa = (10 * np.arange(L, dtype=np.int32))[None]
    if K == "tie":  # K cuts between the two tied neighbors of residue 5
        d = np.linalg.norm(xyz[0, :, 1] - xyz[0, 5, 1], axis=-1)
        d[5] = 1e9
        K = int(np.argsort(d, kind="stable").tolist().index(3)) + 1
        assert d[3] == d[7]
    for exclude_self in (True, False):
        a = tknn.knn_adjacency(torch.from_numpy(xyz), torch.from_numpy(aa), K,
                               exclude_self=exclude_self)
        b = jknn.knn_adjacency(jnp.asarray(xyz), jnp.asarray(aa), K,
                               exclude_self=exclude_self)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tknn.incoming_mask(a).numpy(),
                                      np.asarray(jknn.incoming_mask(b)))
