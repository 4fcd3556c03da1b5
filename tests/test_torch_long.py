"""The port's long-chain serving path against JAX: the gather and bucket
neighborhood indices (bit-equal, ties included), kernel B on its gather
layout, the bucketed and gathered coordinate update, the row-chunked pair
ResNets and head, kernel H, and the tiny whole model with the bucketed SE(3)
layout. Float32, dropout off, the same numpy inputs and one flax parameter
tree on both sides; JAX runs its Pallas kernels in interpret mode, the port
its kernels' plain versions on the CPU. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rosettafold_tpu import tiny_config
from rosettafold_tpu.models import heads as jheads
from rosettafold_tpu.models import pair as jpair
from rosettafold_tpu.models import resnet as jresnet
from rosettafold_tpu.models import se3 as jse3
from rosettafold_tpu.models import structure as jstruct
from rosettafold_tpu.models.rosettafold import RoseTTAFold as JaxRoseTTAFold
from rosettafold_tpu.ops import knn as jknn
from rosettafold_tpu.ops import so3 as jso3
from rosettafold_tpu.ops.pallas import linear_attention as jla
from rosettafold_tpu.ops.pallas import se3_attend as jatt
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch.models import heads as theads
from rosettafold_tpu_torch.models import pair as tpair
from rosettafold_tpu_torch.models import resnet as tresnet
from rosettafold_tpu_torch.models import se3 as tse3
from rosettafold_tpu_torch.models import structure as tstruct
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops.cuda import linear_attention as tla
from rosettafold_tpu_torch.ops.cuda import se3_attend as tatt
from tests.port_utils import port_config, random_params
from tests.test_torch_kernels import SE3_LAYERS, _h_inputs

TOL = 1e-4  # modules and the whole model, float32 (tests/test_torch_modules.py)


class _ParamsOnly:
    """A flax module whose init returns its `params` collection alone: the
    bucket layout sows its overflow into `diagnostics` at init, which
    `random_params` does not draw."""

    def __init__(self, module):
        self.module = module

    def init(self, *args):
        return {"params": self.module.init(*args)["params"]}


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _tied_lattice(B, L, seed):
    """Backbones on an integer lattice (exact distances, so equal ones tie
    exactly) with a few planted ties: residue j + 2 mirrors residue j - 2
    through residue j."""
    rng = np.random.default_rng(seed)
    xyz = np.round(rng.normal(size=(B, L, 3, 3)) * 4.0).astype(np.float32)
    for j in range(2, L - 2, 7):
        xyz[:, j + 2, 1] = 2 * xyz[:, j, 1] - xyz[:, j - 2, 1]
    return xyz


def _edge_set(idx, valid):
    B, L, _ = idx.shape
    adj = np.zeros((B, L, L), dtype=bool)
    for b in range(B):
        for j in range(L):
            adj[b, j, idx[b, j][valid[b, j]]] = True
    return adj


# ------------------------------------------------------------------ indices


@pytest.mark.parametrize("k_dynamic", [None, 5])
@pytest.mark.parametrize("spaced", [False, True])
def test_knn_gather_indices_bit_equal(k_dynamic, spaced):
    """Indices and validity equal JAX's, ties included; with k_dynamic the
    edge set is a static top-k_dynamic's (tests/test_model.py::
    test_dynamic_k_matches_static_gather)."""
    B, L, K = 2, 30, 12
    xyz = _tied_lattice(B, L, 1)
    aa = np.arange(L, dtype=np.int32)[None].repeat(B, 0) * (3 if spaced else 1)
    kd = None if k_dynamic is None else jnp.asarray(k_dynamic)
    ij, vj = jknn.knn_gather_indices(jnp.asarray(xyz), jnp.asarray(aa), K, k_dynamic=kd)
    it, vt = tknn.knn_gather_indices(torch.from_numpy(xyz), torch.from_numpy(aa), K,
                                     k_dynamic=k_dynamic)
    assert it.dtype == torch.int32 and it.is_contiguous() and vt.is_contiguous()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    if k_dynamic is not None:
        i_s, v_s = tknn.knn_gather_indices(torch.from_numpy(xyz), torch.from_numpy(aa), k_dynamic)
        assert (_edge_set(it.numpy(), vt.numpy()) == _edge_set(i_s.numpy(), v_s.numpy())).all()


@pytest.mark.parametrize("k_dynamic", [None, 6])
def test_knn_adjacency_k_dynamic_bit_equal(k_dynamic):
    B, L = 2, 30
    xyz = _tied_lattice(B, L, 2)
    aa = (10 * np.arange(L, dtype=np.int32))[None].repeat(B, 0)
    kd = None if k_dynamic is None else jnp.asarray(k_dynamic)
    a = tknn.knn_adjacency(torch.from_numpy(xyz), torch.from_numpy(aa), 16, k_dynamic=k_dynamic)
    b = jknn.knn_adjacency(jnp.asarray(xyz), jnp.asarray(aa), 16, k_dynamic=kd)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("capacity,k_dynamic", [(None, None), (None, 4), (14, None)])
def test_knn_bucket_indices_bit_equal(capacity, k_dynamic):
    """src_idx, validity and overflow equal JAX's (every slot, the invalid
    ones' indices too); capacity 14 forces overflow."""
    B, L, K = 2, 40, 8
    xyz = _tied_lattice(B, L, 3)
    aa = np.arange(L, dtype=np.int32)[None].repeat(B, 0)
    kd = None if k_dynamic is None else jnp.asarray(k_dynamic)
    ij, vj, oj = jknn.knn_bucket_indices(jnp.asarray(xyz), jnp.asarray(aa), K,
                                         capacity=capacity, k_dynamic=kd)
    it, vt, ot = tknn.knn_bucket_indices(torch.from_numpy(xyz), torch.from_numpy(aa), K,
                                         capacity=capacity, k_dynamic=k_dynamic)
    assert it.dtype == torch.int32 and ot.dtype == torch.int32
    assert it.is_contiguous() and vt.is_contiguous()  # as kernel B reads them
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert (ot.numpy() > 0).all() == (capacity is not None)


def test_bucket_edge_set_matches_adjacency_exactly():
    """At the default capacity the bucket holds exactly the incoming sets of
    knn_adjacency, without duplicates (tests/test_se3.py's test of the same
    name)."""
    B, L, K = 2, 64, 8
    xyz = torch.from_numpy((np.random.default_rng(3).normal(size=(B, L, 3, 3)) * 4.0)
                           .astype(np.float32))
    aa = torch.arange(L)[None].repeat(B, 1)
    cond = tknn.knn_adjacency(xyz, aa, K).numpy()                  # (B, i, j)
    idx, valid, overflow = (t.numpy() for t in tknn.knn_bucket_indices(xyz, aa, K))
    assert (overflow == 0).all()
    assert (_edge_set(idx, valid) == cond.transpose(0, 2, 1)).all()
    for b in range(B):
        for j in range(L):
            v = idx[b, j][valid[b, j]]
            assert len(set(v.tolist())) == len(v)


def test_bucket_overflow_reported_and_band_kept():
    """A tiny capacity overflows, and the dropped edges are the furthest:
    the band |i - j| < 9 survives (tests/test_se3.py's test of the same name)."""
    B, L, K = 1, 48, 16
    xyz = torch.from_numpy((np.random.default_rng(5).normal(size=(B, L, 3, 3)) * 4.0)
                           .astype(np.float32))
    idx, valid, overflow = tknn.knn_bucket_indices(xyz, torch.arange(L)[None], K, capacity=18)
    assert int(overflow[0]) > 0
    for j in range(L):
        kept = set(idx[0, j][valid[0, j]].tolist())
        assert {i for i in range(L) if i != j and abs(i - j) < 9} <= kept, j


# ------------------------------------------------------- kernel B, gather


_basis = jax.jit(lambda rel: jso3.equivariant_basis(rel, 1))
_radii = jax.jit(jso3.edge_radii)
_xla_reference = jax.jit(jatt.xla_reference, static_argnums=(6, 7))


def _gather_case(name, L, S, seed):
    """One GSE3Res layer's kernel operands on the gather layout: src_idx from
    the bucket of random coordinates (invalid slots keep the sort's indices),
    the JAX layer's parameters (numpy draws) in the bridged port module."""
    f_in_d, f_out_d, div, heads = SE3_LAYERS[name]
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy((rng.normal(size=(1, L, 3, 3)) * 5.0).astype(np.float32))
    src, valid, _ = (t.numpy() for t in tknn.knn_bucket_indices(xyz, torch.arange(L)[None], 4,
                                                                  capacity=S))
    ca = xyz[:, :, 1].numpy()
    rel = ca[:, :, None] - ca[0][src]
    basis = {k: np.asarray(v) for k, v in _basis(rel).items()}
    feat = np.concatenate([rng.normal(size=(1, L, S, 64)).astype(np.float32),
                           np.asarray(_radii(rel))], -1)
    h = {d: rng.normal(size=(1, L, m, 2 * d + 1)).astype(np.float32) for d, m in f_in_d.items()}
    jmod = jse3.GSE3Res(jse3.Fiber(f_in_d), jse3.Fiber(f_out_d), edge_dim=64, div=div,
                        n_heads=heads)
    params = random_params(jmod, h, feat, basis, valid,
                           {d: v[0][src] for d, v in h.items()})["params"]
    tmod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), 64, div, heads, impl="pallas")
    tmod.load_state_dict(bridge.module_state_dict(params))
    meta_j = jatt.build_meta(f_in_d, tmod.f_mid_out.dict, tmod.f_mid_in.dict, heads, 64)
    ck = sum((m // heads) * (2 * d + 1) for d, m in tmod.f_mid_in.dict.items())
    return dict(src=src, mask=valid, basis=basis, feat=feat, h=h, tmod=tmod, meta_j=meta_j,
                qh=rng.normal(size=(1, L, heads * ck)).astype(np.float32),
                stacked_j=jatt.stack_weights(params["v"], params["k"], meta_j))


def _port_gather(c, grad=False):
    tmod = c["tmod"]
    h = {d: _torch(v).requires_grad_(grad) for d, v in c["h"].items()}
    feat, qh = _torch(c["feat"]).requires_grad_(grad), _torch(c["qh"]).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        stacked = tatt.stack_weights(tmod.v, tmod.k, tmod.meta)
        z = tatt.gse3_attend(feat, _torch(c["basis"]), h, _torch(c["mask"]), qh,
                             tuple(t.detach() for t in stacked), tmod.meta, _torch(c["src"]))
    return z, (h, feat, qh)


def _jax_gather(c, h, feat, qh):
    """JAX's kernel on the gather layout (interpret mode on the CPU) on
    features pre-gathered along src_idx."""
    src = jnp.asarray(c["src"])
    h_src = {d: jax.vmap(lambda hb, ib: hb[ib])(v, src) for d, v in h.items()}
    return jatt.gse3_attend(feat, c["basis"], h_src, jnp.asarray(c["mask"]), qh,
                            c["stacked_j"], c["meta_j"], False)


@pytest.mark.parametrize("name,L,S,interpret", [
    ("res_0", 16, 12, False), ("res_1", 16, 12, False), ("res_out", 16, 12, False),
    ("res_1", 13, 7, False), ("res_out", 10, 8, True)])
def test_se3_gather_plain_matches_jax(name, L, S, interpret):
    """Kernel B's plain version on the gather layout within 2e-5
    (tests/test_se3_attend.py) of JAX's `xla_reference(dense=False)` at the
    three layer shapes and a ragged one (L = 13, S = 7), and of the Pallas
    kernel itself with dense=False (interpret mode) at the last layer's."""
    c = _gather_case(name, L, S, seed=L + S)
    if interpret:
        z_j = _jax_gather(c, c["h"], jnp.asarray(c["feat"]), jnp.asarray(c["qh"]))
    else:
        h_src = {d: v[0][c["src"]] for d, v in c["h"].items()}
        z_j = _xla_reference(c["feat"], c["basis"], h_src, c["mask"], c["qh"], c["stacked_j"],
                             c["meta_j"], False)
    before = (tatt.launches, tatt.gather_launches)
    z_t, _ = _port_gather(c)
    assert (tatt.launches, tatt.gather_launches) == before  # CPU: the plain version
    for d in z_j:
        np.testing.assert_allclose(z_t[d].numpy(), np.asarray(z_j[d]), rtol=2e-5, atol=2e-5)


def test_se3_gather_vjp_matches_jax():
    """The gradient reaches h through the gather: the port's vjp (the plain
    version's, recomputed) against JAX's backward of the gather layout, the
    vjp of `xla_reference(dense=False)` through the gather (`_bwd_rule`), for
    h, feat and qh, within 5e-5 + 5e-4 relative
    (tests/test_se3_attend.py::test_fused_gradients_match)."""
    c = _gather_case("res_0", 12, 10, seed=4)
    src = jnp.asarray(c["src"])

    def z_j(h, feat, qh):
        h_src = {d: jax.vmap(lambda hb, ib: hb[ib])(v, src) for d, v in h.items()}
        return _xla_reference(feat, c["basis"], h_src, jnp.asarray(c["mask"]), qh,
                              c["stacked_j"], c["meta_j"], False)

    g = {d: np.random.default_rng(d).normal(size=np.shape(v)).astype(np.float32)
         for d, v in z_j(c["h"], c["feat"], c["qh"]).items()}

    def loss(h, feat, qh):
        z = z_j(h, feat, qh)
        return sum(jnp.sum(z[d] * g[d]) for d in z)

    gj = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        {d: jnp.asarray(v) for d, v in c["h"].items()}, jnp.asarray(c["feat"]),
        jnp.asarray(c["qh"]))
    z, (h, feat, qh) = _port_gather(c, grad=True)
    sum((z[d] * _torch(g[d])).sum() for d in z).backward()
    for a, b in [(h[0].grad, gj[0][0]), (h[1].grad, gj[0][1]), (feat.grad, gj[1]),
                 (qh.grad, gj[2])]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)


def test_se3_gather_skips_masked_indices():
    """A masked slot's index is never read: out-of-range indices there change
    nothing (the bucket leaves arbitrary indices in its empty slots)."""
    c = _gather_case("res_1", 12, 12, seed=6)
    assert not c["mask"].all()
    z, _ = _port_gather(c)
    c["src"] = np.where(c["mask"], c["src"], 10 ** 6).astype(np.int32)
    z_bad, _ = _port_gather(c)
    for d in z:
        torch.testing.assert_close(z_bad[d], z[d], rtol=0, atol=0)


# ------------------------------------------------------------------ modules


def _check(jmod, tmod, *args, tol=TOL):
    """Random params (params collection only) for jmod, loaded into tmod; run
    both and compare. Returns the port's output and JAX's sown diagnostics."""
    params = random_params(_ParamsOnly(jmod), *args)
    j_out, state = jax.jit(lambda p, *a: jmod.apply(p, *a, mutable=["diagnostics"]))(
        params, *args)
    tmod.load_state_dict(bridge.module_state_dict(params), strict=True)
    tmod.eval()
    with torch.no_grad():
        t_out = tmod(*[_torch(a) for a in args])
    j_flat, t_flat = jax.tree.leaves(j_out), jax.tree.leaves(
        t_out, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(j_flat) == len(t_flat)
    for a, b in zip(t_flat, j_flat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)
    return t_out, state


@pytest.mark.parametrize("impl,attn,capacity", [("bucket", "pallas", None),
                                                ("bucket", "xla", 24),
                                                ("gather", "xla", None)])
def test_coord_update_long_layouts_match_jax(impl, attn, capacity):
    """CoordUpdateWithMsaAndPair on the bucket and gather layouts at L = 64,
    K = 16 (C = 48 < L; capacity 24 overflows), through kernel B's plain
    version ("pallas") and the per-layer gathered features ("xla"), within
    1e-4, with JAX's overflow."""
    B, N, L = 1, 2, 64
    rng = np.random.default_rng(0)
    kw = dict(d_msa=16, d_pair=8, d_node=8, d_edge=8, d_state=8, n_neighbors=16,
              attn_impl=attn, se3_impl=impl)
    kw["bucket_capacity"] = capacity
    xyz = np.cumsum(rng.normal(size=(B, L, 1, 3)) * 2.2, axis=1) + rng.normal(size=(B, L, 3, 3))
    args = (xyz.astype(np.float32), rng.normal(size=(B, N, L, 16)).astype(np.float32),
            rng.normal(size=(B, L, L, 8)).astype(np.float32),
            np.arange(L, dtype=np.int32)[None],
            np.eye(21, dtype=np.float32)[rng.integers(0, 21, (B, L))])
    tmod = tstruct.CoordUpdateWithMsaAndPair(**kw)
    _, state = _check(jstruct.CoordUpdateWithMsaAndPair(**kw), tmod, *args)
    if impl == "bucket":
        overflow = state["diagnostics"]["se3_bucket_overflow"][0]
        np.testing.assert_array_equal(tmod.bucket_overflow.numpy(), np.asarray(overflow))
        assert (int(overflow[0]) > 0) == (capacity is not None)


LC = 20  # rows, chunked by 7: chunks 7, 7, 6


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_resnet_and_head_row_chunked_match_jax(conv_impl):
    """The row-chunked ResNet and PredictionHead against JAX's (plain
    branch), within 1e-4; "pallas": the port's blocks through kernel F's
    plain version with the chunked epilogue (JAX's towers cannot lower their
    crossover, so they run the plain branch: the same math)."""
    x = np.random.default_rng(1).normal(size=(1, LC, LC, 8)).astype(np.float32)
    tres = tresnet.ResNet(4, 8, 8, 5, row_chunk=7, conv_impl=conv_impl)
    thead = theads.PredictionHead(8, n_res_blocks=2, row_chunk=7, conv_impl=conv_impl)
    for mod in (tres, thead):
        for blk in mod.modules():
            if isinstance(blk, tresnet.ResBlock2D):
                blk.fused_min_l = 1
    _check(jresnet.ResNet(4, 8, 8, 5, row_chunk=7), tres, x)
    _check(jheads.PredictionHead(in_channels=8, n_res_blocks=2, row_chunk=7), thead, x)


@pytest.mark.parametrize("kernels", [False, True])
def test_pair_update_with_msa_row_chunked_matches_jax(kernels):
    """The pair track's conv block with row_chunk, plain (chunked convs) and
    kernel branch (kernel F's plain version, chunked epilogue), within 1e-4."""
    rng = np.random.default_rng(2)
    kw = dict(d_msa=16, d_proj=8, d_pair=8, n_heads=4, attn_impl="pallas" if kernels else "xla",
              row_chunk=7)
    if kernels:
        kw["conv_fused_min_l"] = 1
    _check(jpair.PairUpdateWithMsa(**kw), tpair.PairUpdateWithMsa(**kw),
           rng.normal(size=(1, 3, LC, 16)).astype(np.float32),
           rng.normal(size=(1, LC, LC, 8)).astype(np.float32),
           np.abs(rng.normal(size=(1, LC, LC, 4))).astype(np.float32))


def test_axial_layer_ff_chunked_matches_jax():
    kw = dict(d_pair=8, d_ff=16, n_heads=2, performer_dim_head=4, ff_chunk=7)
    _check(jpair.PairUpdateWithAxialAttentionLayer(**kw),
           tpair.PairUpdateWithAxialAttentionLayer(**kw),
           np.random.default_rng(3).normal(size=(1, LC, LC, 8)).astype(np.float32))


# ------------------------------------------------------------------ kernel H


@pytest.mark.parametrize("shape", [(5, 40, 16, 48), (3, 37, 64, 320)])
def test_linear_attention_plain_matches_jax(shape):
    """H's plain version against the Pallas kernel (interpret mode), forward
    and gradient within 3e-5 (tests/test_pallas.py:87), at that test's shape
    and at m = 320; in bfloat16, within one bf16 rounding of the output."""
    q, k, v, proj = _h_inputs(*shape)
    fn = jax.jit(jla.generalized_linear_attention, static_argnums=(4, 5))
    before = tla.launches
    out = tla.generalized_linear_attention(*map(torch.from_numpy, (q, k, v, proj)))
    assert tla.launches == before and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(fn(q, k, v, proj, 1e-3, 2)), atol=3e-5)

    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    gj = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c, proj, 1e-3, 2) * g), argnums=(0, 1, 2))(
        q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tla.generalized_linear_attention(*leaves, torch.from_numpy(proj))
     * torch.from_numpy(g)).sum().backward()
    for a, b in zip(leaves, gj):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=3e-5)

    qb, kb, vb, pb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, proj))
    out_b = tla.generalized_linear_attention(
        *(torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16() for x in (qb, kb, vb, pb)))
    assert out_b.dtype == torch.bfloat16
    np.testing.assert_allclose(out_b.float().numpy(),
                               np.asarray(fn(qb, kb, vb, pb, 1e-3, 2).astype(jnp.float32)),
                               atol=1e-2, rtol=2.0 ** -8)


@pytest.mark.parametrize("bad", ["rank", "proj", "device"])
def test_linear_attention_wrapper_rejects(bad):
    q, k, v, proj = map(torch.from_numpy, _h_inputs(2, 8, 16, 32))
    if bad == "rank":
        q = q[None]
    elif bad == "proj":
        proj = proj[:, :8]
    else:
        proj = proj.to("meta")
    with pytest.raises((ValueError, TypeError)):
        tla.generalized_linear_attention(q, k, v, proj)


# ------------------------------------------------------------- whole model


def test_slice_bucket_matches_jax():
    """tiny_config(attn_impl="pallas", scan_blocks=True, se3_impl="bucket") at
    L = 40: the three-track block's top-k at K_max = 8, C = 32 < L; float32
    within 1e-4, and the final block's overflow equal to JAX's sown one."""
    L = 40
    cfg = tiny_config(attn_impl="pallas", scan_blocks=True, se3_impl="bucket", p_dropout=0.0)
    msa = np.random.default_rng(4).integers(0, 21, (1, 2, L)).astype(np.int32)
    inputs = (msa, msa[:, 0], np.arange(L, dtype=np.int32)[None])
    params = random_params(_ParamsOnly(JaxRoseTTAFold(config=cfg)), *inputs)
    (logits_j, xyz_j, plddt_j), state = jax.jit(
        lambda p, *a: JaxRoseTTAFold(config=cfg).apply(p, *a, mutable=["diagnostics"]))(
        params, *inputs)
    tcfg = port_config(cfg)
    model = RoseTTAFold(tcfg, init=False)
    model.load_state_dict(bridge.state_dict_from_flax(params, tcfg), strict=True)
    blocks = [model.three_track_0, model.final_block]
    assert [b.coord_update_with_msa_and_pair.n_neighbors for b in blocks] == [8, 32]
    with torch.no_grad():
        logits, xyz, plddt = model(*map(torch.from_numpy, inputs))
    for k in logits_j:
        np.testing.assert_allclose(logits[k].numpy(), np.asarray(logits_j[k]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plddt.numpy(), np.asarray(plddt_j), atol=TOL, rtol=TOL)
    sown = state["diagnostics"]["final_block"]["coord_update_with_msa_and_pair"]
    np.testing.assert_array_equal(
        blocks[1].coord_update_with_msa_and_pair.bucket_overflow.numpy(),
        np.asarray(sown["se3_bucket_overflow"][0]))
