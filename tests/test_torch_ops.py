"""The PyTorch port's ops against the JAX package: host constants bit-equal,
device math at float32 tolerance, the serving-config pin, the port's own
copies of the JAX package's config and data modules, and the port's freedom
from jax and from the JAX package."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rosettafold_tpu import config as jconfig
from rosettafold_tpu import predict as jpredict
from rosettafold_tpu.data import a3m as ja3m
from rosettafold_tpu.data import pdb as jpdb
from rosettafold_tpu.ops import knn as jknn
from rosettafold_tpu.ops import performer as jfavor
from rosettafold_tpu.ops import so3 as jso3
from rosettafold_tpu.ops.sinusoidal import sinusoidal_table as j_sinusoidal_table
from rosettafold_tpu_torch import config as tconfig
from rosettafold_tpu_torch import predict as tpredict
from rosettafold_tpu_torch.data import a3m as ta3m
from rosettafold_tpu_torch.data import pdb as tpdb
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops import performer as tfavor
from rosettafold_tpu_torch.ops import so3 as tso3
from rosettafold_tpu_torch.ops.sinusoidal import sinusoidal_table as t_sinusoidal_table

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A3M = os.path.join(REPO, "examples", "demo_casp.a3m")


def test_port_imports_no_jax():
    """Every module of the port, and then chip_smoke.py (imported, not run),
    import with neither jax, flax, optax, orbax nor any module of the JAX
    package in sys.modules."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import rosettafold_tpu_torch as pkg

        def bad():
            return sorted(k for k in sys.modules if k == "jax"
                          or k.startswith(("jax.", "flax", "optax", "orbax"))
                          or k.split(".")[0] == "rosettafold_tpu")

        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        assert not bad(), bad()
        spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not bad(), bad()
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def test_port_sources_import_no_jax_package():
    """No import statement of the port or of chip_smoke.py, at any depth
    (function-local imports included), names jax, flax, optax, orbax or
    rosettafold_tpu."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "rosettafold_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                              "rosettafold_tpu")]
    assert len(files) > 20 and not bad, bad


@pytest.mark.parametrize("L", [16, 96, 127, 128, 400, 1500])
def test_fast_config_pinned_to_jax(L):
    """Two config classes, one per package, compared field by field."""
    t, j = tpredict.fast_config(L), jpredict.fast_config(L)
    assert type(t) is tconfig.RoseTTAFoldConfig and type(t) is not type(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("cls", ["RoseTTAFoldConfig", "PerformerConfig"])
def test_config_copy_matches_jax(cls):
    """The port's config classes have the JAX package's fields and defaults."""
    t, j = getattr(tconfig, cls), getattr(jconfig, cls)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())
    assert dataclasses.asdict(tconfig.tiny_config()) == dataclasses.asdict(jconfig.tiny_config())
    assert dataclasses.asdict(tconfig.tiny_config(d_msa=8, attn_impl="pallas")) == \
        dataclasses.asdict(jconfig.tiny_config(d_msa=8, attn_impl="pallas"))


@pytest.mark.parametrize("subsample", ["first", "diversity"])
def test_a3m_features_bit_equal(subsample):
    tokens = ta3m.load_a3m(A3M)
    np.testing.assert_array_equal(tokens, ja3m.load_a3m(A3M))
    for n_seq, crop in ((8, 50), (64, None)):
        a = ta3m.msa_features(tokens, n_seq=n_seq, crop_len=crop, subsample=subsample)
        b = ja3m.msa_features(tokens, n_seq=n_seq, crop_len=crop, subsample=subsample)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_write_pdb_same_bytes(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(17, 3, 3)).astype(np.float32) * 10
    seq = rng.integers(0, 21, 17)
    plddt = rng.uniform(size=17)
    tpdb.write_pdb(str(tmp_path / "t.pdb"), xyz, seq, plddt)
    jpdb.write_pdb(str(tmp_path / "j.pdb"), xyz, seq, plddt)
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()


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
