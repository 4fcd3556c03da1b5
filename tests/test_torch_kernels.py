"""The port's kernels: A (tied attention), B (SE(3) attend, dense and gather
layouts), C (fused LN + FAVOR+ + residual), D (fused LN + FF + residual), E
(fused outer-product mean), F (3x3 conv), H (FAVOR+ linear attention; its
CPU tests against JAX are in tests/test_torch_long.py) and LN (the model's
LayerNorm, which replaces no TPU kernel; its plain version is
`models/layers.py` `layer_norm`).

On the CPU the wrappers run their plain PyTorch versions, which are held here
against the JAX functions (Pallas interpret mode, or the file's own plain
reference). The kernels themselves compile and run only on a CUDA card: the
tests marked `gpu` compare them with the plain versions there and skip here.
The card's machine has no JAX, so they need none; run them there with
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch.config import RoseTTAFoldConfig
from rosettafold_tpu_torch.models import layers as tlayers
from rosettafold_tpu_torch.models import resnet as tresnet
from rosettafold_tpu_torch.models import se3 as tse3
from rosettafold_tpu_torch.models import structure as tstruct
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold, init_like_flax
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops import so3 as tso3
from rosettafold_tpu_torch.ops.cuda import linear_attention as tla
from rosettafold_tpu_torch.ops.cuda import conv3x3 as tconv
from rosettafold_tpu_torch.ops.cuda import fused_ff as tff
from rosettafold_tpu_torch.ops.cuda import fused_performer as tfp
from rosettafold_tpu_torch.ops.cuda import layer_norm as tln
from rosettafold_tpu_torch.ops.cuda import outer_product as topm
from rosettafold_tpu_torch.ops.cuda import se3_attend as tatt
from rosettafold_tpu_torch.ops.cuda import tied_attention as ttied
from rosettafold_tpu_torch.ops.performer import gaussian_orthogonal_matrix
from rosettafold_tpu_torch.predict import build_model, fast_config

try:  # the JAX reference: present on the CPU test host, absent beside the card
    import jax
    import jax.numpy as jnp

    from rosettafold_tpu.models import resnet as jresnet
    from rosettafold_tpu.models import se3 as jse3
    from rosettafold_tpu.ops import knn as jknn
    from rosettafold_tpu.ops import so3 as jso3
    from rosettafold_tpu.ops.pallas import conv3x3 as jconv
    from rosettafold_tpu.ops.pallas import fused_ff as jff
    from rosettafold_tpu.ops.pallas import fused_performer as jfp
    from rosettafold_tpu.ops.pallas import outer_product as jopm
    from rosettafold_tpu.ops.pallas import se3_attend as jatt
    from rosettafold_tpu.ops.pallas import tied_attention as jtied
    from tests.port_utils import one_thread  # noqa: F401 (autouse fixture)
    from tests.port_utils import random_params
except ImportError:
    jax = None

# (f_in, f_out, div, heads): the three GSE3Res layers of the model's SE(3)
# transformer at flagship width (d_node 64, 16 channels, d_state 32)
SE3_LAYERS = {
    "res_0": ({0: 64, 1: 3}, {0: 16, 1: 16}, 4, 4),
    "res_1": ({0: 16, 1: 16}, {0: 16, 1: 16}, 4, 4),
    "res_out": ({0: 16, 1: 16}, {0: 32, 1: 3}, 1, 1),
}
EDGE_DIM = 64


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs the JAX reference package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels do not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _writable(a):
    """A torch tensor of a copy of `a` (JAX's arrays come back read-only)."""
    return torch.from_numpy(np.array(a))


def _qkv(BH, L, ND, NDv, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(BH, L, ND)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(BH, L, ND)) * 0.3).astype(np.float32)
    v = rng.normal(size=(BH, L, NDv)).astype(np.float32)
    return q, k, v


# (BH, L, ND, NDv): ragged L (no multiple of 128 or of the kernel tiles), and
# ND > 256 (N = 12 MSA rows of d = 32)
TIED_CASES = [(3, 77, 96, 96), (2, 40, 384, 384), (2, 130, 64, 64)]


@pytest.mark.parametrize("shape", TIED_CASES)
def test_tied_plain_matches_jax(needs_jax, shape):
    q, k, v = _qkv(*shape)
    out_j, lse_j = jax.jit(lambda a, b, c: jtied._forward(a, b, c, 1024, 1024))(q, k, v)
    before = ttied.launches
    out_t, lse_t = ttied.tied_attention_forward(*map(torch.from_numpy, (q, k, v)))
    assert ttied.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=2e-5)


def test_tied_plain_matches_jax_bf16(needs_jax):
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(2, 50, 64, 64, 3)))
    out_j = jax.jit(jtied.tied_flash_attention)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (q, k, v))
    out_t = ttied.tied_flash_attention(tq, tk, tv)
    assert out_t.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) on values of size ~1
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
                               atol=1e-2)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mismatch"])
def test_tied_wrapper_rejects(bad):
    q, k, v = map(torch.from_numpy, _qkv(2, 8, 16, 16))
    if bad == "rank":
        q = q[None]
    elif bad == "dtype":
        q = q.double()
    else:
        k = k[:, :4]
    with pytest.raises((ValueError, TypeError)):
        ttied.tied_flash_attention(q, k, v)


def _se3_case(name, L=12, B=1, seed=0):
    """Inputs, JAX params and the bridged port module for one layer shape."""
    f_in_d, f_out_d, div, heads = SE3_LAYERS[name]
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, L, 3, 3)) * 5.0).astype(np.float32)
    ca = xyz[:, :, 1]
    rel = (ca[:, :, None, :] - ca[:, None, :, :]).astype(np.float32)
    aa = np.arange(L, dtype=np.int32)[None].repeat(B, 0)
    mask = np.asarray(jknn.incoming_mask(jknn.knn_adjacency(
        jnp.asarray(xyz), jnp.asarray(aa), 4)))
    basis = {k: np.asarray(v) for k, v in jso3.equivariant_basis(jnp.asarray(rel), 1).items()}
    feat = np.concatenate([rng.normal(size=(B, L, L, EDGE_DIM)).astype(np.float32),
                           np.asarray(jso3.edge_radii(jnp.asarray(rel)))], -1)
    h = {d: rng.normal(size=(B, L, m, 2 * d + 1)).astype(np.float32)
         for d, m in f_in_d.items()}
    jmod = jse3.GSE3Res(jse3.Fiber(f_in_d), jse3.Fiber(f_out_d), edge_dim=EDGE_DIM,
                        div=div, n_heads=heads)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), h, feat, basis, mask)["params"]
    tmod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), EDGE_DIM, div, heads,
                        impl="pallas")
    tmod.load_state_dict(bridge.module_state_dict(jax.tree.map(np.asarray, params)))
    meta_j = jatt.build_meta(f_in_d, tmod.f_mid_out.dict, tmod.f_mid_in.dict, heads, EDGE_DIM)
    ck = sum((m // heads) * (2 * d + 1) for d, m in tmod.f_mid_in.dict.items())
    qh = rng.normal(size=(B, L, heads * ck)).astype(np.float32)
    return dict(feat=feat, basis=basis, h=h, mask=mask, qh=qh, params=params,
                tmod=tmod, meta_j=meta_j)


@pytest.mark.parametrize("name", list(SE3_LAYERS))
def test_se3_stack_weights_and_plain_match_jax(needs_jax, name):
    c = _se3_case(name)
    tmod = c["tmod"]
    assert tuple(map(tuple, tmod.meta.pairs)) == tuple(map(tuple, c["meta_j"].pairs))
    stacked_j = jatt.stack_weights(c["params"]["v"], c["params"]["k"], c["meta_j"])
    with torch.no_grad():
        stacked_t = tatt.stack_weights(tmod.v, tmod.k, tmod.meta)
    for a, b in zip(stacked_t, stacked_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z_j = jatt.xla_reference(c["feat"], c["basis"], c["h"], c["mask"], c["qh"], stacked_j,
                             c["meta_j"], dense=True)
    T = _writable
    before = tatt.launches
    with torch.no_grad():
        z_t = tatt.gse3_attend(T(c["feat"]), {k: T(v) for k, v in c["basis"].items()},
                               {d: T(v) for d, v in c["h"].items()}, T(c["mask"]),
                               T(c["qh"]), stacked_t, tmod.meta)
    assert tatt.launches == before
    for d in z_j:
        np.testing.assert_allclose(z_t[d].numpy(), np.asarray(z_j[d]), rtol=2e-5, atol=2e-5)


def test_se3_plain_matches_jax_kernel_interpret(needs_jax):
    """Against the Pallas kernel itself (interpret mode) at the last layer's shape."""
    c = _se3_case("res_out", L=10, seed=1)
    stacked_j = jatt.stack_weights(c["params"]["v"], c["params"]["k"], c["meta_j"])
    z_j = jatt.gse3_attend(jnp.asarray(c["feat"]), c["basis"], c["h"], jnp.asarray(c["mask"]),
                           jnp.asarray(c["qh"]), stacked_j, c["meta_j"], True)
    T = _writable
    with torch.no_grad():
        z_t = tatt.gse3_attend(T(c["feat"]), {k: T(v) for k, v in c["basis"].items()},
                               {d: T(v) for d, v in c["h"].items()}, T(c["mask"]),
                               T(c["qh"]), tatt.stack_weights(c["tmod"].v, c["tmod"].k,
                                                              c["tmod"].meta),
                               c["tmod"].meta)
    for d in z_j:
        np.testing.assert_allclose(z_t[d].numpy(), np.asarray(z_j[d]), rtol=2e-5, atol=2e-5)


def test_se3_wrapper_rejects_gather_layout(needs_jax):
    """Features of S != L nodes without src_idx are no dense layout and raise;
    with src_idx (the gather layout) the same features are taken."""
    c = _se3_case("res_1", L=8)
    T = _writable
    h = {d: T(v[:, :5]) for d, v in c["h"].items()}  # S != L: not the dense layout
    args = (T(c["feat"]), {k: T(v) for k, v in c["basis"].items()}, h, T(c["mask"]),
            T(c["qh"]), tatt.stack_weights(c["tmod"].v, c["tmod"].k, c["tmod"].meta),
            c["tmod"].meta)
    with pytest.raises(ValueError):
        tatt.gse3_attend(*args)
    src = torch.arange(8 * 8, dtype=torch.int32).reshape(1, 8, 8) % 5
    with torch.no_grad():
        z = tatt.gse3_attend(*args, src_idx=src)
    assert all(z[d].shape[:2] == (1, 8) for d in z)
    with pytest.raises(ValueError):  # the index must be int32 (B, J, S)
        tatt.gse3_attend(*args, src_idx=src.long())


# the bf16 kernels' tiling edges: ragged L (77; 120 and 250 off the 64-row
# tiles), every MSA depth the model path runs (ND = NDv = 32 N, N = 8, 16, 32,
# 64: one launch at L <= 128, NDv <= 256, two above), B*H = 5 (no multiple of
# the grid)
TIED_EDGE_CASES = [(5, L, 32 * N, 32 * N) for L in (77, 120, 250) for N in (8, 16, 32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TIED_CASES + [(48, 120, 2048, 2048)] + TIED_EDGE_CASES)
def test_tied_kernel_matches_plain_on_card(cuda, shape, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(*shape))
    out, lse = ttied.tied_attention_forward(q, k, v)
    ref, ref_lse = ttied.tied_attention_plain(q, k, v)
    torch.cuda.synchronize()
    # bf16: within two bf16 ulps (2^-6 relative) of the plain value, + 1e-2
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (1e-2, 2.0 ** -6)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SE3_LAYERS))
def test_se3_kernel_matches_plain_on_card(cuda, name):
    f_in_d, f_out_d, div, heads = SE3_LAYERS[name]
    B, L = 2, 40
    g = torch.Generator().manual_seed(0)
    mod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), EDGE_DIM, div, heads,
                       impl="pallas")
    init_like_flax(mod, g)
    mod = mod.to(cuda)
    xyz = (torch.randn(B, L, 3, 3, generator=g) * 5.0).to(cuda)
    aa = torch.arange(L, device=cuda)[None].repeat(B, 1)
    mask = tknn.incoming_mask(tknn.knn_adjacency(xyz, aa, 8)).contiguous()
    ca = xyz[:, :, 1]
    rel = ca[:, :, None, :] - ca[:, None, :, :]
    basis = {k: v.contiguous() for k, v in tso3.equivariant_basis(rel, 1).items()}
    feat = torch.cat([torch.randn(B, L, L, EDGE_DIM, generator=g).to(cuda),
                      tso3.edge_radii(rel)], -1).contiguous()
    h = {d: torch.randn(B, L, m, 2 * d + 1, generator=g).to(cuda) for d, m in f_in_d.items()}
    ck = sum((m // heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
    qh = torch.randn(B, L, heads * ck, generator=g).to(cuda)
    with torch.no_grad():
        stacked = tatt.stack_weights(mod.v, mod.k, mod.meta)
        args = (feat, basis, h, mask, qh, stacked, mod.meta)
        before = tatt.launches
        z = tatt.gse3_attend(*args)
        ref = tatt.se3_attend_plain(*args)
    torch.cuda.synchronize()
    assert tatt.launches == before + 1
    for d in ref:
        torch.testing.assert_close(z[d], ref[d], rtol=2e-5, atol=2e-5)


def _se3_card_inputs(cuda, name, L, k, S=None, B=1, seed=0, edge_dim=EDGE_DIM):
    """A GSE3Res layer with random weights and its kernel B operands on the
    card: the dense kNN layout (S == L) or, with S, the bucket (gather)
    layout of a random-walk backbone with capacity S."""
    f_in_d, f_out_d, div, heads = SE3_LAYERS[name]
    g = torch.Generator().manual_seed(seed)
    mod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), edge_dim, div, heads,
                       impl="pallas")
    init_like_flax(mod, g)
    mod = mod.to(cuda)
    xyz = torch.cumsum(torch.randn(B, L, 3, 3, generator=g) * 2.2, 1).to(cuda)
    aa = torch.arange(L, device=cuda)[None].repeat(B, 1)
    ca = xyz[:, :, 1]
    if S is None:
        src = None
        mask = tknn.incoming_mask(tknn.knn_adjacency(xyz, aa, k)).contiguous()
        rel = ca[:, :, None, :] - ca[:, None, :, :]
    else:
        src, mask, _ = tknn.knn_bucket_indices(xyz, aa, k, capacity=S)
        rel = torch.stack([ca[b][:, None] - ca[b][src[b].long()] for b in range(B)])
    n_slots = mask.shape[-1]
    basis = {key: v.contiguous() for key, v in tso3.equivariant_basis(rel, 1).items()}
    feat = torch.cat([torch.randn(B, L, n_slots, edge_dim, generator=g).to(cuda),
                      tso3.edge_radii(rel)], -1).contiguous()
    h = {d: torch.randn(B, L, m, 2 * d + 1, generator=g).to(cuda) for d, m in f_in_d.items()}
    ck = sum((m // heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
    qh = torch.randn(B, L, heads * ck, generator=g).to(cuda)
    with torch.no_grad():
        stacked = tatt.stack_weights(mod.v, mod.k, mod.meta)
    return [feat, basis, h, mask, qh, stacked, mod.meta, src]


def _se3_check_on_card(args):
    """Kernel B against its plain version at the JAX kernel test's 2e-5, one
    launch counted on the layout's counter."""
    gather = args[-1] is not None
    with torch.no_grad():
        before = (tatt.launches, tatt.gather_launches)
        z = tatt.gse3_attend(*args)
        ref = tatt.se3_attend_plain(*args)
    torch.cuda.synchronize()
    assert (tatt.launches, tatt.gather_launches) == (before[0] + (not gather),
                                                      before[1] + gather)
    for d in ref:
        torch.testing.assert_close(z[d], ref[d], rtol=2e-5, atol=2e-5)
    return z


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SE3_LAYERS))
@pytest.mark.parametrize("L", [128, 250])
def test_se3_kernel_dense_serving_shapes_on_card(cuda, name, L):
    """The dense layout at the serving L = 128 (B = 2) and at L = 250 (S no
    multiple of the 64-edge tiles)."""
    _se3_check_on_card(_se3_card_inputs(cuda, name, L, 64, B=2 if L == 128 else 1))


@pytest.mark.gpu
@pytest.mark.parametrize("edge_dim", [32, 40])
def test_se3_kernel_edge_widths_on_card(cuda, edge_dim):
    """Edge features of 33 and 41 columns (the tiny config's d_edge 32 + the
    radius): one 32-column chunk on the tensor cores, 1 and 9 columns past it
    in float32."""
    _se3_check_on_card(_se3_card_inputs(cuda, "res_0", 96, 16, B=2, edge_dim=edge_dim))


@pytest.mark.gpu
@pytest.mark.parametrize("gather", [False, True])
def test_se3_kernel_empty_and_single_edge_destinations_on_card(cuda, gather):
    """A destination with no unmasked edge gives 0; one with exactly one
    edge gives that edge's value message (weight 1)."""
    args = _se3_card_inputs(cuda, "res_1", 96, 16, S=48 if gather else None, B=4)
    mask = args[3].clone()
    mask[0, 0] = False
    mask[0, 1] = False
    mask[0, 1, 5] = True
    mask[0, 7:12] = False  # a run of empty destinations
    args[3] = mask
    if gather:  # the slot made valid names a node
        args[-1] = args[-1].clone()
        args[-1][0, 1, 5] = 3
    z = _se3_check_on_card(args)
    for d in z:
        assert bool((z[d][0, 0] == 0).all()) and bool((z[d][0, 7:12] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SE3_LAYERS))
@pytest.mark.parametrize("L,S,k", [(512, 80, 32), (512, 272, 128)])
def test_se3_gather_kernel_ignores_masked_indices_on_card(cuda, name, L, S, k):
    """The gather layout at the long requests' bucket capacities, with
    garbage (out-of-range) indices in every masked slot: never read."""
    args = _se3_card_inputs(cuda, name, L, k, S=S)
    src, mask = args[-1], args[3]
    garbage = torch.randint(-(1 << 30), 1 << 30, src.shape, generator=torch.Generator()
                            .manual_seed(1)).to(cuda, torch.int32)
    args[-1] = torch.where(mask, src, garbage).contiguous()
    assert bool((args[-1][~mask] >= L).any()) or bool((args[-1][~mask] < 0).any())
    _se3_check_on_card(args)


def _h_inputs(P, L, dh, m, seed=0, std=None):
    """Kernel H's operands: q, k of std `std` (default dh^-0.25), v unit, the
    seed-0 FAVOR+ projection (m, dh)."""
    rng = np.random.default_rng(seed)
    s = dh ** -0.25 if std is None else std
    q, k = ((rng.normal(size=(P, L, dh)) * s).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(P, L, dh)).astype(np.float32)
    return q, k, v, gaussian_orthogonal_matrix(m, dh, seed=0).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SE3_LAYERS))
@pytest.mark.parametrize("L,S", [(300, 272), (77, 33)])
def test_se3_gather_kernel_matches_plain_on_card(cuda, name, L, S):
    f_in_d, f_out_d, div, heads = SE3_LAYERS[name]
    g = torch.Generator().manual_seed(0)
    mod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), 64, div, heads, impl="pallas")
    init_like_flax(mod, g)
    mod = mod.to(cuda)
    xyz = torch.cumsum(torch.randn(1, L, 3, 3, generator=g) * 2.2, 1).to(cuda)
    src, mask, _ = tknn.knn_bucket_indices(xyz, torch.arange(L, device=cuda)[None], 64,
                                           capacity=S)
    ca = xyz[:, :, 1]
    rel = ca[:, :, None] - ca[0][src.long()]
    basis = {k: v.contiguous() for k, v in tso3.equivariant_basis(rel, 1).items()}
    feat = torch.cat([torch.randn(1, L, S, 64, generator=g).to(cuda), tso3.edge_radii(rel)],
                     -1).contiguous()
    h = {d: torch.randn(1, L, m, 2 * d + 1, generator=g).to(cuda) for d, m in f_in_d.items()}
    ck = sum((m // heads) * (2 * d + 1) for d, m in mod.f_mid_in.dict.items())
    qh = torch.randn(1, L, heads * ck, generator=g).to(cuda)
    with torch.no_grad():
        args = (feat, basis, h, mask, qh, tatt.stack_weights(mod.v, mod.k, mod.meta), mod.meta,
                src)
        before = (tatt.launches, tatt.gather_launches)
        z = tatt.gse3_attend(*args)
        ref = tatt.se3_attend_plain(*args)
    torch.cuda.synchronize()
    assert (tatt.launches, tatt.gather_launches) == (before[0], before[1] + 1)
    for d in ref:
        torch.testing.assert_close(z[d], ref[d], rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_se3_scatter_layout_on_card(cuda):
    """The scatter SE(3) layout (plain segment ops, which use atomics on the
    card, so it is held by tolerance) in the coordinate update at flagship
    SE(3) width, L = 96, K = 16, with one residue that no edge points at (an
    empty destination segment): on the card against the same module on the
    CPU within 1e-4, and against the dense layout on the card within 2e-4
    (tests/test_torch_configs.py); kernel B is not launched."""
    L, K = 96, 16
    g = torch.Generator().manual_seed(0)
    kw = dict(d_msa=32, d_pair=16, d_node=64, d_edge=64, d_state=32, n_neighbors=K,
              p_dropout=0.0, attn_impl="pallas")
    scatter = tstruct.CoordUpdateWithMsaAndPair(se3_impl="scatter", **kw)
    init_like_flax(scatter, g)
    dense = tstruct.CoordUpdateWithMsaAndPair(se3_impl="dense", **kw)
    dense.load_state_dict(scatter.state_dict())
    xyz = (torch.cumsum(torch.randn(1, L, 1, 3, generator=g) * 2.2, 1)
           + torch.randn(1, L, 3, 3, generator=g))
    xyz[:, 40] += 1e3
    aa = (10 * torch.arange(L))[None]  # no band edges
    idx, valid = tknn.knn_gather_indices(xyz, aa, K)
    assert 40 not in set(idx[valid].tolist())
    args = (xyz, torch.randn(1, 4, L, 32, generator=g), torch.randn(1, L, L, 16, generator=g),
            aa, torch.nn.functional.one_hot(torch.randint(0, 21, (1, L), generator=g), 21).float())
    with torch.no_grad():
        ref = scatter.eval()(*args)
        on_card = [a.to(cuda) for a in args]
        before = (tatt.launches, tatt.gather_launches)
        out = scatter.to(cuda)(*on_card)
        torch.cuda.synchronize()
        assert (tatt.launches, tatt.gather_launches) == before
        out_dense = dense.eval().to(cuda)(*on_card)
    for a, b, c in zip(out, ref, out_dense):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a, c, atol=2e-4, rtol=0)


# (P, L, m, q/k std or None for dh^-0.25): the bench shape at L=512, a ragged
# one, L around the bf16 kernel's 64-position chunks, P around its persistent
# grid, every feature-slice count up to the largest, and q, k at std 1.0
H_CARD_CASES = ([(64, 512, 320, None), (7, 77, 320, None)]
                + [(3, L, 320, None) for L in (1, 63, 64, 65, 200, 513)]
                + [(P, 130, 320, None) for P in (1, 3, 300)]
                + [(5, 200, m, None) for m in (64, 192, 320)]
                + [(16, 256, 320, 1.0)])


def _h_card(cuda, dtype, P, L, m=320, std=None, seed=0):
    return tuple(torch.from_numpy(x).to(cuda, dtype) for x in _h_inputs(P, L, 64, m, seed, std))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,L,m,std", H_CARD_CASES)
def test_linear_attention_kernel_matches_plain_on_card(cuda, dtype, P, L, m, std):
    q, k, v, proj = _h_card(cuda, dtype, P, L, m, std)
    before = tla.launches
    out = tla.generalized_linear_attention(q, k, v, proj)
    ref = tla.linear_attention_plain(q, k, v, proj)
    torch.cuda.synchronize()
    assert tla.launches == before + 1 and out.dtype == dtype
    # float32: the JAX kernel test's 3e-5; bf16: two bf16 ulps (2^-6) + 1e-2
    atol, rtol = (3e-5, 3e-5) if dtype == torch.float32 else (1e-2, 2.0 ** -6)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    if dtype == torch.bfloat16 and (P, L) == (64, 512):
        # the feature maps, ctx and ksum held to float32 as JAX's kernel holds
        # them: at least 99 % of the outputs equal the float32 plain version
        # rounded once (bf16-rounded feature maps and ctx give about 81 %)
        assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_kernel_keeps_problems_apart_on_card(cuda, dtype):
    """Problem 0 (L = 33, less than one 64-position chunk) gives the same bits
    beside a problem of large k and v as alone: no position of one problem
    reaches another's ctx or normalizer."""
    q, k, v, proj = _h_card(cuda, dtype, 2, 33)
    k[1] = k[1] * 4 + 1
    v[1] = v[1] * 1000
    both = tla.generalized_linear_attention(q, k, v, proj)
    alone = tla.generalized_linear_attention(q[:1], k[:1], v[:1], proj)
    torch.cuda.synchronize()
    assert torch.equal(both[:1], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_kernel_is_deterministic_on_card(cuda, dtype):
    q, k, v, proj = _h_card(cuda, dtype, 300, 200)
    a = tla.generalized_linear_attention(q, k, v, proj)
    b = tla.generalized_linear_attention(q, k, v, proj)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# ------------------------------------------------------- pair-track kernels
# C, D, E and F at tiny widths on the CPU; the JAX tolerances are those of
# tests/test_pallas.py (C 3e-5, D 2e-5), tests/test_pair.py (E 2e-5) and
# tests/test_conv3x3.py (F 2e-5 float32, 3e-2 bfloat16).


def _affine(rng, n):
    return ((1.0 + 0.1 * rng.normal(size=n)).astype(np.float32),
            (0.1 * rng.normal(size=n)).astype(np.float32))


def _ff_args(D=24, F=48, seed=0, x_shape=(2, 6, 10)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape + (D,)).astype(np.float32)
    g, b = _affine(rng, D)
    w1 = (rng.normal(size=(D, F)) * 0.2).astype(np.float32)
    b1 = (0.1 * rng.normal(size=F)).astype(np.float32)
    w2 = (rng.normal(size=(F, D)) * 0.2).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    return x, g, b, w1, b1, w2, b2


def test_ff_plain_matches_jax(needs_jax):
    args = _ff_args()
    j = jax.jit(jff.fused_ln_ff_residual, static_argnums=(7,))(*args, 1e-5)
    before = tff.launches
    t = tff.fused_ln_ff_residual(*map(torch.from_numpy, args), 1e-5)
    assert tff.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jff._xla_composed(*args, 1e-5)), atol=2e-5)


def _conv_args(B=2, H=8, W=8, C=6, Co=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) * 0.1).astype(np.float32)
    inv = (rng.normal(size=(B, C)) * 0.5 + 1.0).astype(np.float32)
    shift = (rng.normal(size=(B, C)) * 0.1).astype(np.float32)
    return x, w, (inv, shift)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("with_pre", [False, True])
def test_conv_plain_matches_jax(needs_jax, dilation, with_pre):
    x, w, pre = _conv_args()
    pre = pre if with_pre else None
    j = jconv.conv3x3_fused(x, w, pre, dilation, jnp.float32, 8)
    tpre = None if pre is None else tuple(map(torch.from_numpy, pre))
    t = tconv.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w), tpre, dilation)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jconv.shifted_gemm_conv(x, w, pre, dilation, jnp.float32)),
        atol=2e-5, rtol=2e-5)


def test_conv_plain_matches_jax_bf16(needs_jax):
    x, w, pre = _conv_args(seed=1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    j = jconv.conv3x3_fused(xb, wb, pre, 2, jnp.bfloat16, 8)
    t = tconv.conv3x3_fused(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                            tuple(map(torch.from_numpy, pre)), 2)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_opm_plain_matches_jax(needs_jax):
    rng = np.random.default_rng(0)
    B, N, L, u, Dp = 1, 3, 14, 8, 20
    x = rng.normal(size=(B, N, L, u)).astype(np.float32)
    y = (x * rng.uniform(size=(B, N, L, 1))).astype(np.float32)
    g, b = _affine(rng, u * u)
    w = (rng.normal(size=(u * u, Dp)) / u).astype(np.float32)
    bias = (0.1 * rng.normal(size=Dp)).astype(np.float32)
    args = (x, y, g, b, w, bias)
    j = jopm.fused_outer_product_mean(*args, 1e-5, jnp.float32)
    before = topm.launches
    t = topm.fused_outer_product_mean(*map(torch.from_numpy, args), 1e-5)
    assert topm.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jopm.xla_reference(*args, 1e-5, jnp.float32)), atol=2e-5)


def _performer_args(x_shape, seed=0, D=24, h=2, dh=16, m=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape + (D,)).astype(np.float32)
    g, b = _affine(rng, D)
    wq, wk, wv = ((rng.normal(size=(D, h * dh)) * 0.2).astype(np.float32) for _ in range(3))
    wo = (rng.normal(size=(h * dh, D)) * 0.2).astype(np.float32)
    bo = (0.1 * rng.normal(size=D)).astype(np.float32)
    proj = rng.normal(size=(m, dh)).astype(np.float32)
    return x, (g, b), (wq, wk, wv, wo, bo, proj), (dh ** -0.25, 1e-3, h, dh)


# (axis, LN + residual): the row step (axis 1 of (B, L1, L2, D), which the
# JAX kernel reads strided only at L1 % 128 == 0) and the (R, L, D) form
@pytest.mark.parametrize("axis1", [False, True])
@pytest.mark.parametrize("lnres", [True, False])
def test_performer_plain_matches_jax(needs_jax, axis1, lnres):
    x, ln, w, statics = _performer_args((1, 128, 8) if axis1 else (4, 20), seed=int(axis1))
    fn = {(True, True): "fused_ln_performer_residual_axis1",
          (True, False): "fused_performer_layer_axis1",
          (False, True): "fused_ln_performer_residual",
          (False, False): "fused_performer_layer"}[axis1, lnres]
    jargs = (x, *ln, *w, *statics, 1e-5) if lnres else (x, *w, *statics)
    static = tuple(range(len(jargs) - (5 if lnres else 4), len(jargs)))
    j = jax.jit(getattr(jfp, fn), static_argnums=static)(*jargs)
    T = torch.from_numpy
    targs = ((T(x), *map(T, ln), *map(T, w), *statics, 1e-5) if lnres
             else (T(x), *map(T, w), *statics))
    before = tfp.launches
    t = getattr(tfp, fn)(*targs)
    assert tfp.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5)
    if not lnres and not axis1:
        want = jfp.xla_reference(x, *w, *statics)
        np.testing.assert_allclose(t.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("bad", ["ff_dtype", "conv_weight", "opm_x_dtype", "performer_rank"])
def test_pair_kernel_wrappers_reject(bad):
    T = torch.from_numpy
    with pytest.raises((ValueError, TypeError)):
        if bad == "ff_dtype":
            x, g, b, w1, b1, w2, b2 = map(T, _ff_args())
            tff.fused_ln_ff_residual(x, g, b, w1.double(), b1, w2, b2, 1e-5)
        elif bad == "conv_weight":
            x, w, _ = _conv_args()
            tconv.conv3x3_fused(T(x), T(w)[:, :, :3], None, 1)
        elif bad == "opm_x_dtype":
            x = torch.zeros(1, 2, 4, 8, dtype=torch.bfloat16)
            topm.fused_outer_product_mean(x, x, torch.ones(64), torch.zeros(64),
                                          torch.zeros(64, 4, dtype=torch.bfloat16),
                                          torch.zeros(4))
        else:
            x, ln, w, statics = _performer_args((4, 20))
            tfp.fused_performer_layer_axis1(T(x), *map(T, w), *statics)


# ---- on the card: each kernel against its plain version at serving width
# bf16 bound: two bf16 ulps of the value (2^-6 relative) + 1e-2, as kernel A;
# both sides round the same intermediates, in other summation orders.
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -6


def _close(out, ref, f32_tol):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=f32_tol, rtol=f32_tol)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


def _card(a, cuda, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dtype)


# (x shape, hidden width F): the bf16 kernel's blocks are 128 rows (two
# warpgroups of 64), so M = 120 and 100 are less than one block (one of them
# less than a warpgroup's rows in its second), 128 exactly one, 5929 and 6150
# off the blocks; F = 64 and 192 are one and three of its hidden chunks (its
# weight rings have two stages)
FF_CARD_CASES = [((2, 6, 10), 1152), ((1, 1, 100), 1152), ((1, 2, 64), 1152),
                 ((1, 77, 77), 1152), ((3, 50, 41), 1152), ((2, 6, 10), 64),
                 ((1, 77, 77), 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,F", FF_CARD_CASES)
def test_ff_kernel_matches_plain_on_card(cuda, dtype, x_shape, F):
    x, g, b, w1, b1, w2, b2 = _ff_args(D=288, F=F, x_shape=x_shape)
    w1, w2 = w1 / 4, w2 / 8
    args = (_card(x, cuda, dtype), _card(g, cuda), _card(b, cuda), _card(w1, cuda, dtype),
            _card(b1, cuda), _card(w2, cuda, dtype), _card(b2, cuda), 1e-5)
    before = tff.launches
    out = tff.fused_ln_ff_residual(*args)
    ref = tff.fused_ff_plain(*args)
    torch.cuda.synchronize()
    assert tff.launches == before + 1
    _close(out, ref, 2e-5)


# (B, H, W, dilation, pre-op, float32 out): the bf16 kernel's block is 128
# pixels of a row (two warpgroups of 64) and its input segments 64 + 2d
# pixels, so W = 127/128/129/250 hit its ragged tails, W = 5 at dilation 8
# and H = 1 taps and kernel rows wholly outside the image, dilation 100 its
# per-tap segments; float32 out from bf16 is F's input-gradient mode
CONV_CARD_CASES = [
    (2, 37, 70, 1, False, False), (2, 37, 70, 2, True, False), (2, 37, 70, 8, True, False),
    (1, 3, 127, 1, True, False), (1, 3, 128, 2, False, False), (1, 3, 129, 4, True, False),
    (1, 2, 250, 8, False, False), (1, 3, 5, 8, True, False), (1, 1, 70, 1, True, False),
    (1, 1, 250, 4, False, False), (4, 5, 40, 2, True, False), (2, 6, 129, 1, True, True),
    (1, 4, 250, 8, True, True), (1, 3, 70, 100, True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,dilation,with_pre,out_f32", CONV_CARD_CASES)
def test_conv_kernel_matches_plain_on_card(cuda, dtype, B, H, W, dilation, with_pre, out_f32):
    x, w, pre = _conv_args(B=B, H=H, W=W, C=288, Co=288)
    w = w / 4
    tx, tw = _card(x, cuda, dtype), _card(w, cuda, dtype)
    tpre = tuple(_card(p, cuda) for p in pre) if with_pre else None
    out_dtype = torch.float32 if out_f32 else dtype
    before = tconv.launches
    out = tconv.conv3x3_fused(tx, tw, tpre, dilation, out_dtype)
    ref = tconv.conv3x3_plain(tx, tw, tpre, dilation, out_dtype)
    torch.cuda.synchronize()
    assert tconv.launches == before + 1 and out.dtype == out_dtype
    _close(out, ref, 2e-5)


# (B, N, L): the bf16 kernel's tiles are 8 rows i x 16 columns j, its K
# steps 16 MSA rows, at most 64 of them resident (N = 100 stages them 64 at a
# time); L = 1, 63, 65, 129, 200 cut tiles at a row's end, N = 1, 19 pad a K
# step, B = 3 crosses the batch within the grid's walk
OPM_CARD_CASES = [(B, N, L) for B in (1, 3) for N in (1, 8, 19, 64) for L in (1, 63, 65, 129, 200)]
OPM_CARD_CASES += [(2, 8, 37), (2, 19, 37), (1, 100, 65)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,L", OPM_CARD_CASES)
def test_opm_kernel_matches_plain_on_card(cuda, dtype, B, N, L):
    rng = np.random.default_rng(N * 1000 + L)
    x = rng.normal(size=(B, N, L, 32)).astype(np.float32)
    y = rng.normal(size=(B, N, L, 32)).astype(np.float32)
    g, b = _affine(rng, 1024)
    w = (rng.normal(size=(1024, 288)) / 32).astype(np.float32)
    bias = (0.1 * rng.normal(size=288)).astype(np.float32)
    args = (_card(x, cuda), _card(y, cuda, dtype), _card(g, cuda), _card(b, cuda),
            _card(w, cuda, dtype), _card(bias, cuda), 1e-5, dtype)
    before = topm.launches
    out = topm.fused_outer_product_mean(*args)
    ref = topm.outer_product_plain(*args)
    torch.cuda.synchronize()
    assert topm.launches == before + 1
    _close(out, ref, 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis1,lnres", [(True, True), (False, True), (True, False),
                                         (False, False)])
@pytest.mark.parametrize("shape", [(2, 70, 37), (3, 77, 130), (1, 129, 64), (1, 9, 5),
                                   (2, 64, 1)])
def test_performer_kernel_matches_plain_on_card(cuda, dtype, axis1, lnres, shape):
    """Both axes, with and without LN/residual; problems and positions off the
    bf16 FAVOR+ launch's 64-position chunks and its grid (and one exactly on
    them: L = 64); rows P * L off the bf16 projection's and output launch's
    128-row blocks, one less than a block (45) and one exactly on it (128)."""
    x, ln, w, statics = _performer_args(shape, D=288, h=8, dh=64, m=320)
    w = tuple(a / 2 for a in w[:4]) + w[4:]
    tx = _card(x, cuda, dtype)
    tln = (_card(ln[0], cuda), _card(ln[1], cuda), 1e-5) if lnres else None
    tw = [_card(a, cuda, dtype) for a in w[:5]] + [_card(w[5], cuda)]
    before = tfp.launches
    if axis1:
        fn = tfp.fused_ln_performer_residual_axis1 if lnres else tfp.fused_performer_layer_axis1
    else:
        fn = tfp.fused_ln_performer_residual if lnres else tfp.fused_performer_layer
    xin = tx if axis1 else tx.reshape(-1, *tx.shape[2:])
    out = fn(xin, *tln[:2], *tw, *statics, tln[2]) if lnres else fn(xin, *tw, *statics)
    ref = tfp.performer_plain(xin, tln, *tw, *statics, 1 if axis1 else 2)
    torch.cuda.synchronize()
    assert tfp.launches == before + 1
    _close(out, ref, 3e-5)


# ------------------------------------------------------------ the backwards
# Each wrapper is differentiable; on the CPU its backward runs the plain
# versions (G, C' and F's float32 input gradient written out; D, E and B
# by recomputation), held here against jax.vjp of the JAX functions at the
# JAX gradient tests' tolerances (G 3e-5, tests/test_pallas.py:41,166; C'
# 2e-4 + 1e-3 relative, :268,320; F 2e-5, tests/test_conv3x3.py:99).


def _vjp_torch(fn, inputs, g):
    """Gradients of fn(*inputs) for cotangent g, through autograd (inputs
    None stay None)."""
    leaves = [None if a is None else torch.from_numpy(np.array(a)).requires_grad_()
              for a in inputs]
    out = fn(*leaves)
    wrt = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(out, wrt, torch.from_numpy(np.array(g))))
    return [None if t is None else next(got).numpy() for t in leaves]


@pytest.mark.parametrize("L", [20, 130])
def test_tied_backward_plain_matches_jax(needs_jax, L):
    q, k, v = _qkv(2, L, 48, 40, seed=L)
    g = np.random.default_rng(L).normal(size=(2, L, 40)).astype(np.float32)
    _, vjp = jax.vjp(jtied.tied_flash_attention, q, k, v)
    want = vjp(g)
    before = ttied.bwd_launches
    got = _vjp_torch(ttied.tied_flash_attention, (q, k, v), g)
    assert ttied.bwd_launches == before  # CPU tensors take the plain version
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5)


@pytest.mark.parametrize("axis1", [False, True])
@pytest.mark.parametrize("lnres", [True, False])
def test_performer_backward_plain_matches_jax(needs_jax, axis1, lnres):
    x, ln, w, statics = _performer_args((1, 128, 8) if axis1 else (4, 20), seed=2 + int(axis1))
    gy = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    fn = {(True, True): "fused_ln_performer_residual_axis1",
          (True, False): "fused_performer_layer_axis1",
          (False, True): "fused_ln_performer_residual",
          (False, False): "fused_performer_layer"}[axis1, lnres]
    diff = (x, *ln, *w[:5]) if lnres else (x, *w[:5])  # projection: no gradient
    tail = (*statics, 1e-5) if lnres else statics
    _, vjp = jax.vjp(lambda *a: getattr(jfp, fn)(*a, w[5], *tail), *diff)
    want = vjp(gy)
    before = tfp.bwd_launches
    got = _vjp_torch(lambda *a: getattr(tfp, fn)(*a, torch.from_numpy(w[5]), *tail), diff, gy)
    assert tfp.bwd_launches == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dilation", [1, 4])
@pytest.mark.parametrize("with_pre", [False, True])
def test_conv_backward_plain_matches_jax(needs_jax, dilation, with_pre):
    x, w, pre = _conv_args(seed=dilation)
    g = np.random.default_rng(6).normal(size=x.shape[:3] + (w.shape[-1],)).astype(np.float32)
    args = (x, w, *pre) if with_pre else (x, w)

    def jfn(x_, w_, *p):
        return jconv.conv3x3_fused(x_, w_, tuple(p) if p else None, dilation, jnp.float32, 8)

    _, vjp = jax.vjp(jfn, *args)
    want = vjp(g)
    before = tconv.bwd_launches
    got = _vjp_torch(lambda x_, w_, *p: tconv.conv3x3_fused(x_, w_, tuple(p) if p else None,
                                                            dilation), args, g)
    assert tconv.bwd_launches == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv_block_weight_grad_bf16_matches_jax(needs_jax, dilation):
    """The bf16 residual conv block on kernel F (dropout off: conv1 without
    the pre-op, conv2 with it) on the model's float32 weights: the weight
    gradients against jax.vjp of JAX's kernel path (bf16 x, float32 kernel,
    each tap summed in float32, dw in float32), within float32 summation
    error. A dw rounded to bf16 misses by one bf16 rounding (~2e-3)."""
    C, shape = 16, (1, 16, 16, 16)
    x = np.random.default_rng(dilation).normal(size=shape).astype(np.float32)
    g = np.random.default_rng(10 + dilation).normal(size=shape).astype(np.float32)
    kw = dict(dilation=dilation, conv_impl="pallas", fused_min_l=1)
    jmod = jresnet.ResBlock2D(C, dtype=jnp.bfloat16, **kw)
    params = random_params(jmod, x)
    _, vjp = jax.vjp(lambda p: jmod.apply(p, jnp.asarray(x, jnp.bfloat16)), params)
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tmod = tresnet.ResBlock2D(C, dtype=torch.bfloat16, **kw)
    tmod.load_state_dict(bridge.module_state_dict(params), strict=True)
    tmod.eval()
    out = tmod(torch.from_numpy(x).bfloat16())
    out.backward(torch.from_numpy(g).bfloat16())
    for name in ("conv1", "conv2"):
        conv = getattr(tmod, name)
        assert conv.weight.grad.dtype == torch.float32
        jw = np.asarray(want["params"][name]["kernel"])
        np.testing.assert_allclose(conv.weight.grad.permute(2, 3, 1, 0).numpy(), jw,
                                   rtol=1e-4, atol=1e-4 * np.abs(jw).max(), err_msg=name)


def test_ff_and_opm_backward_match_jax(needs_jax):
    """D and E: the recompute backward against jax.grad (the JAX functions'
    plain backwards, `fused_ff._bwd_rule`, `outer_product._bwd`); E's with
    its row chunks (BWD_CHUNK cut to 8 for 14 rows)."""
    args = _ff_args()
    gy = np.random.default_rng(7).normal(size=args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jff.fused_ln_ff_residual(*a, 1e-5), *args)
    got = _vjp_torch(lambda *a: tff.fused_ln_ff_residual(*a, 1e-5), args, gy)
    for a, b in zip(got, vjp(gy)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=2e-5)

    rng = np.random.default_rng(8)
    B, N, L, u, Dp = 1, 3, 14, 8, 20
    x = rng.normal(size=(B, N, L, u)).astype(np.float32)
    y = (x * rng.uniform(size=(B, N, L, 1))).astype(np.float32)
    g_, b_ = _affine(rng, u * u)
    w = (rng.normal(size=(u * u, Dp)) / u).astype(np.float32)
    bias = (0.1 * rng.normal(size=Dp)).astype(np.float32)
    gout = rng.normal(size=(B, L, L, Dp)).astype(np.float32)
    opm = (x, y, g_, b_, w, bias)
    _, vjp = jax.vjp(lambda *a: jopm.fused_outer_product_mean(*a, 1e-5, jnp.float32), *opm)
    chunk, topm.BWD_CHUNK = topm.BWD_CHUNK, 8
    try:
        got = _vjp_torch(lambda *a: topm.fused_outer_product_mean(*a, 1e-5), opm, gout)
    finally:
        topm.BWD_CHUNK = chunk
    for a, b in zip(got, vjp(gout)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=2e-5)


def test_se3_backward_matches_jax(needs_jax):
    """B: the recompute backward against JAX's, which is the vjp of the
    file's plain `xla_reference` (`se3_attend._bwd_rule`), for the node
    features, the query, the edge features and the stacked weights."""
    c = _se3_case("res_1", L=10, seed=2)
    stacked_j = jatt.stack_weights(c["params"]["v"], c["params"]["k"], c["meta_j"])
    basis, mask = c["basis"], jnp.asarray(c["mask"])
    rng = np.random.default_rng(9)

    def jfn(feat, h0, h1, qh, *st):
        z = jatt.xla_reference(feat, basis, {0: h0, 1: h1}, mask, qh, tuple(st), c["meta_j"],
                               dense=True)
        return [z[d] for d, _ in c["meta_j"].f_value]

    inputs = (c["feat"], c["h"][0], c["h"][1], c["qh"], *map(np.asarray, stacked_j))
    out, vjp = jax.vjp(jax.jit(jfn), *inputs)
    gz = [rng.normal(size=o.shape).astype(np.float32) for o in out]
    want = vjp(gz)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    tb = {k: _writable(v) for k, v in basis.items()}
    z = tatt.gse3_attend(leaves[0], tb, {0: leaves[1], 1: leaves[2]}, _writable(c["mask"]),
                         leaves[3], tuple(leaves[4:]), c["tmod"].meta)
    outs = [z[d] for d, _ in c["tmod"].meta.f_value]
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(g) for g in gz])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=2e-5)


def _no_grad_case(name):
    """(wrapper, its float inputs, its autograd.Function) at a small CPU shape."""
    T = torch.from_numpy
    if name == "tied_attention":
        return ttied.tied_flash_attention, tuple(map(T, _qkv(2, 9, 16, 16))), \
            ttied._TiedFlashAttention
    if name == "fused_ff":
        return (lambda *a: tff.fused_ln_ff_residual(*a, 1e-5)), tuple(map(T, _ff_args())), \
            tff._FusedFF
    if name == "conv3x3":
        x, w, pre = _conv_args()
        return (lambda x_, w_, *p: tconv.conv3x3_fused(x_, w_, p, 2)), \
            tuple(map(T, (x, w, *pre))), tconv._Conv3x3
    if name == "outer_product":
        rng = np.random.default_rng(0)
        x = rng.normal(size=(1, 3, 6, 4)).astype(np.float32)
        opm = (x, x * 0.5, *_affine(rng, 16), (rng.normal(size=(16, 5)) / 4).astype(np.float32),
               np.zeros(5, np.float32))
        return topm.fused_outer_product_mean, tuple(map(T, opm)), topm._OuterProductMean
    if name == "fused_performer":
        x, ln, w, statics = _performer_args((2, 9))
        return (lambda *a: tfp.fused_ln_performer_residual(*a, *statics, 1e-5)), \
            tuple(map(T, (x, *ln, *w))), tfp._Performer
    f_in_d, f_out_d, div, heads = SE3_LAYERS["res_1"]
    tmod = tse3.GSE3Res(tse3.Fiber(f_in_d), tse3.Fiber(f_out_d), EDGE_DIM, div, heads,
                        impl="pallas")
    g = torch.Generator().manual_seed(0)
    init_like_flax(tmod, g)
    B, L = 1, 8
    xyz = torch.randn(B, L, 3, 3, generator=g) * 5.0
    mask = tknn.incoming_mask(tknn.knn_adjacency(xyz, torch.arange(L)[None], 4))
    rel = xyz[:, :, None, 1] - xyz[:, None, :, 1]
    basis = tso3.equivariant_basis(rel, 1)
    feat = torch.cat([torch.randn(B, L, L, EDGE_DIM, generator=g), tso3.edge_radii(rel)], -1)
    h = {d: torch.randn(B, L, m, 2 * d + 1, generator=g) for d, m in f_in_d.items()}
    ck = sum((m // heads) * (2 * d + 1) for d, m in tmod.f_mid_in.dict.items())
    qh = torch.randn(B, L, heads * ck, generator=g)
    stacked = tatt.stack_weights(tmod.v, tmod.k, tmod.meta)
    return (lambda f, q: tatt.gse3_attend(f, basis, h, mask, q, stacked, tmod.meta)), \
        (feat, qh), tatt._GSE3Attend


@pytest.mark.parametrize("name", ["tied_attention", "se3_attend", "fused_performer", "fused_ff",
                                  "outer_product", "conv3x3"])
def test_wrapper_without_grad_mode_bypasses_autograd(name, monkeypatch):
    """Serving adds no autograd work: in grad mode a wrapper records its
    autograd.Function; without grad mode it calls its forward directly and
    returns the same values."""
    fn, inputs, function = _no_grad_case(name)
    want = fn(*(t.detach().requires_grad_() for t in inputs))
    outs = lambda o: list(o.values()) if isinstance(o, dict) else [o]  # noqa: E731
    assert all(type(t.grad_fn).__name__ == f"{function.__name__}Backward" for t in outs(want))

    def refuse(*a, **k):
        raise AssertionError(f"{function.__name__}.apply without grad mode")
    monkeypatch.setattr(function, "apply", refuse)
    with torch.inference_mode():
        got = fn(*inputs)
    for a, b in zip(outs(got), outs(want), strict=True):
        assert torch.equal(a, b.detach())


# ---- on the card: each backward kernel against its plain version
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 77, 96, 96), (2, 130, 512, 512), (5, 120, 256, 256)])
@pytest.mark.parametrize("forward", ["plain", "kernel"])
def test_tied_backward_kernel_matches_plain_on_card(cuda, shape, dtype, forward):
    """G from the saved out and lse of A's plain version or of kernel A (as
    on the model path)."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(*shape))
    out, lse = (ttied.tied_attention_plain if forward == "plain"
                else ttied.tied_attention_forward)(q, k, v)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    before = ttied.bwd_launches
    got = ttied.tied_attention_backward(q, k, v, out, lse, g)
    want = ttied.tied_attention_bwd_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert ttied.bwd_launches == before + 1
    for a, b in zip(got, want):
        _close_grad(a, b, 3e-5, 0.0, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [77, 250])
@pytest.mark.parametrize("N", [8, 16, 64])
def test_tied_backward_kernel_msa_depths_on_card(cuda, L, N, dtype):
    """G at ragged L and at MSA depths N = 8, 16, 64 (ND = 32 N up to 2048:
    launches 2 and 3 of the bf16 path at 4-16 column slices), from kernel A's
    out and lse. Both dtypes hold the absolute term at max(1, max|ref|)
    times the gradient tolerance: at ND = 2048 the gradients reach 50-75,
    and float32 summation order alone moves them by ~3e-5."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(5, L, 32 * N, 32 * N))
    out, lse = ttied.tied_attention_forward(q, k, v)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    before = ttied.bwd_launches
    got = ttied.tied_attention_backward(q, k, v, out, lse, g)
    want = ttied.tied_attention_bwd_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert ttied.bwd_launches == before + 1
    for a, b in zip(got, want):
        if dtype == torch.float32:
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, atol=3e-5 * scale, rtol=0.0)
        else:
            _close_grad(a, b, 3e-5, 0.0, dtype)


def _close_grad(out, ref, atol, rtol, dtype):
    """A gradient computed in `dtype`: float32 at the JAX gradient
    tolerances; bf16 as _close with the absolute term scaled by
    max(1, max|ref|) (a gradient has no unit scale). The dtype of the
    computation decides, not the output's: dgamma, dbeta and dbo are
    float32 sums of bf16 terms."""
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    else:
        scale = max(1.0, float(ref.float().abs().max()))
        torch.testing.assert_close(out.float(), ref.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)


# (B, L1, L2): problems and positions off the bf16 FAVOR+ backward's 64-position
# chunks (L = 5, 37, 64, 77, 129, 130), a block's item walk, and the weight
# gradients' 64-position row chunks
PERFORMER_BWD_CASES = [(1, 9, 5), (2, 70, 37), (1, 129, 64), (3, 77, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis1,lnres", [(True, False), (False, True), (True, True),
                                         (False, False)])
@pytest.mark.parametrize("shape", PERFORMER_BWD_CASES)
def test_performer_backward_kernel_matches_plain_on_card(cuda, dtype, axis1, lnres, shape):
    x, ln, w, statics = _performer_args(shape, D=288, h=8, dh=64, m=320)
    w = tuple(a / 2 for a in w[:4]) + w[4:]
    tx = _card(x, cuda, dtype)
    gy = torch.randn(tx.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype) * 0.1
    tln = (_card(ln[0], cuda), _card(ln[1], cuda), 1e-5) if lnres else None
    tw = [_card(a, cuda, dtype) for a in w[:4]]
    proj = _card(w[5], cuda)
    xin, gin = (tx, gy) if axis1 else (tx.reshape(-1, *tx.shape[2:]), gy.reshape(-1, *gy.shape[2:]))
    axis = 1 if axis1 else 2
    before = tfp.bwd_launches
    got = tfp.performer_backward(xin, tln, *tw, proj, *statics, axis, gin)
    want = tfp.performer_backward(xin, tln, *tw, proj, *statics, axis, gin,
                                  core=tfp.attn_backward_plain)
    torch.cuda.synchronize()
    assert tfp.bwd_launches == before + 1
    for a, b in zip(got, want):
        if b is not None:
            _close_grad(a, b, 2e-4, 1e-3, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("axis1", [True, False])
def test_performer_backward_weight_grads_repeat_on_card(cuda, axis1):
    """bf16 C' gives equal bits for the weight gradients on two calls: split-K
    partials summed in a fixed order, slices summed in a fixed order."""
    x, ln, w, statics = _performer_args((4, 128, 128), D=288, h=8, dh=64, m=320)
    tx = _card(x, cuda, torch.bfloat16)
    gy = (torch.randn(tx.shape, generator=torch.Generator().manual_seed(2)) * 0.05).to(
        cuda, torch.bfloat16)
    tw = [_card(a / 2, cuda, torch.bfloat16) for a in w[:4]]
    proj = _card(w[5], cuda)
    xin, gin = (tx, gy) if axis1 else (tx.reshape(-1, *tx.shape[2:]), gy.reshape(-1, *gy.shape[2:]))
    axis = 1 if axis1 else 2
    first = tfp.performer_backward(xin, None, *tw, proj, *statics, axis, gin)
    second = tfp.performer_backward(xin, None, *tw, proj, *statics, axis, gin)
    torch.cuda.synchronize()
    for a, b in zip(first[3:], second[3:]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,dilation", [
    (2, 37, 70, 1), (2, 37, 70, 8), (1, 3, 127, 2), (1, 3, 129, 4), (1, 2, 250, 8),
    (1, 1, 128, 1), (4, 4, 70, 2), (1, 3, 5, 8)])
def test_conv_input_grad_kernel_matches_plain_on_card(cuda, dtype, B, H, W, dilation):
    x, w, _ = _conv_args(B=B, H=H, W=W, C=288, Co=288)
    g, tw = _card(x, cuda, dtype), _card(w / 4, cuda, dtype)
    before = tconv.bwd_launches
    got = tconv.conv3x3_input_grad(g, tw, dilation)
    want = tconv.conv3x3_plain(g, torch.flip(tw, (0, 1)).transpose(2, 3), None, dilation,
                               torch.float32)
    torch.cuda.synchronize()
    assert tconv.bwd_launches == before + 1 and got.dtype == torch.float32
    # float32 out from the same inputs and float32 sums on both sides, in
    # either input dtype: the F tolerance, relative to the output's scale
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=2e-5)


# --- kernel LN: the model's LayerNorm (csrc/layer_norm.cu) ---------------------


@pytest.mark.parametrize("cfg,impl", [(fast_config(160), "pallas"),
                                      (RoseTTAFoldConfig(max_len=260), "xla")])
def test_layer_norm_impl_follows_attn_impl(cfg, impl):
    """The model sets every LayerNorm's impl to its attn_impl: the fast
    preset takes kernel LN, the exact preset (predict's default) keeps the
    plain version."""
    with torch.device("meta"):
        model = RoseTTAFold(cfg, init=False)
    impls = {m.impl for m in model.modules() if isinstance(m, tlayers.LayerNorm)}
    assert impls == {impl}
    assert tlayers.LayerNorm(8).impl == "xla"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", [False, True])
def test_layer_norm_pallas_on_cpu_is_plain(dtype, view):
    """On a CPU tensor LayerNorm with impl "pallas" is `layer_norm`, bit for
    bit, and launches nothing: kernel LN's wrapper serves a CPU tensor with
    the plain version, as every wrapper does, and `plain_calls` counts only
    what autograd keeps off the kernel."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0.5, 1.0, size=(2, 5, 7, 24)).astype(np.float32)).to(dtype)
    if view:  # the sequence-wise MSA layers' transposed view
        x = x.transpose(1, 2)
    ln = tlayers.LayerNorm(24)
    ln.weight.data, ln.bias.data = (torch.from_numpy(a) for a in _affine(rng, 24))
    ln.impl = "pallas"
    calls, launches = tlayers.plain_calls, tln.launches
    with torch.no_grad():
        got = ln(x)
        want = tlayers.layer_norm(x, ln.weight, ln.bias, ln.eps)
    assert torch.equal(got, want) and got.dtype == torch.float32
    assert tlayers.plain_calls == calls and tln.launches == launches


# (grad mode, x requires grad, parameters require grad, impl) -> kernel taken
NORM_CASES = [((False, True, True, "pallas"), True),
              ((True, False, False, "pallas"), True),
              ((True, True, False, "pallas"), False),
              ((True, False, True, "pallas"), False),
              ((False, False, False, "xla"), False)]


@pytest.mark.parametrize("case,kernel", NORM_CASES)
def test_norm_takes_kernel_only_where_autograd_records_nothing(monkeypatch, case, kernel):
    """`norm` goes to kernel LN's wrapper only with impl "pallas" and while
    autograd records nothing: training keeps the plain version, which has a
    backward; every plain call with impl "pallas" is counted."""
    grad, x_grad, p_grad, impl = case
    taken = []
    monkeypatch.setattr(tln, "fused_layer_norm", lambda *a: taken.append(a) or a[0].float())
    x = torch.randn(3, 16, requires_grad=x_grad)
    w, b = torch.ones(16, requires_grad=p_grad), torch.zeros(16, requires_grad=p_grad)
    calls = tlayers.plain_calls
    with torch.set_grad_enabled(grad):
        tlayers.norm(x, w, b, 1e-5, impl)
    assert len(taken) == int(kernel)
    assert tlayers.plain_calls == calls + int(not kernel and impl == "pallas")


def test_layer_norm_rows_of_folds_leading_axes():
    """Rows of a view are read in place over at most three strided axes."""
    x = torch.zeros(2, 6, 5, 8)
    assert tln.rows_of(x) == ((1, 1, 60), (0, 0, 8))
    assert tln.rows_of(x.transpose(1, 2)) == ((2, 5, 6), (240, 8, 40))
    assert tln.rows_of(x[:1].transpose(1, 2)) == ((1, 5, 6), (0, 8, 40))
    assert tln.rows_of(x[:, ::2]) == ((1, 6, 5), (0, 80, 8))  # B folds into the step
    with pytest.raises(ValueError):
        tln.rows_of(torch.zeros(2, 3, 4, 5, 8).permute(0, 2, 1, 3, 4)[:, :, :, ::2])
    w = torch.ones(8)
    assert tln.vector_loads(x, w, w, tln.rows_of(x)[1])
    odd = torch.zeros(4, 361)  # float32 rows of 1444 bytes: one element a load
    assert not tln.vector_loads(odd, torch.ones(361), torch.ones(361), tln.rows_of(odd)[1])


@pytest.mark.parametrize("bad", ["float16", "float64", "bf16_weight", "last_axis", "shape",
                                 "devices"])
def test_layer_norm_wrapper_rejects(bad):
    x, w, b = torch.zeros(4, 8), torch.ones(8), torch.zeros(8)
    err = ValueError
    if bad in ("float16", "float64"):
        x, err = x.to(getattr(torch, bad)), TypeError
    elif bad == "bf16_weight":
        w, err = w.bfloat16(), TypeError
    elif bad == "last_axis":
        x = torch.zeros(8, 4).t()
    elif bad == "shape":
        w = torch.ones(9)
    else:
        x = torch.zeros(4, 8, device="meta")
    with pytest.raises(err):
        tln.fused_layer_norm(x, w, b, 1e-5)


def _ln_case(cuda, shape, dtype, seed=0, C=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    C = C or shape[-1]
    x = (torch.randn(*shape, generator=g, device=cuda) + 0.5).to(dtype)
    w = 1.0 + 0.1 * torch.randn(C, generator=g, device=cuda)
    b = 0.1 * torch.randn(C, generator=g, device=cuda)
    return x, w, b


def _ln_check(x, w, b):
    before = tln.launches
    got = tln.fused_layer_norm(x, w, b, 1e-5)
    want = tlayers.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert tln.launches == before + 1
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == x.shape
    # float32 statistics on both sides, summed in another order (lanes, then
    # shuffles, against PyTorch's reductions): the F32 kernels' tolerance
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((1, 384, 384, 288), torch.bfloat16),
                                         ((1, 1100, 1100, 288), torch.bfloat16),
                                         ((1, 64, 384, 384), torch.float32)])
def test_layer_norm_kernel_matches_plain_on_card(cuda, shape, dtype):
    """The main path's shapes: the pair at L = 384 and 1100, the MSA."""
    _ln_check(*_ln_case(cuda, shape, dtype))


@pytest.mark.gpu
def test_layer_norm_kernel_reads_transposed_msa_in_place_on_card(cuda):
    """The sequence-wise layers' transposed MSA: read in place, no copy."""
    x, w, b = _ln_case(cuda, (1, 64, 384, 384), torch.float32)
    xt = x.transpose(1, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tln.fused_layer_norm(xt, w, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= got.numel() * 4
    del got
    _ln_check(xt, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [32, 64, 256, 361, 1024, 2304])
@pytest.mark.parametrize("misaligned", [False, True])
def test_layer_norm_kernel_widths_on_card(cuda, C, dtype, misaligned):
    """Every width the model uses, at 4099 rows (no block's multiple), on
    the vector path and, from a row start off 16 bytes, on the one-element
    path; rows longer than a lane group's registers are read twice."""
    x, w, b = _ln_case(cuda, (4099 * C + 1,), dtype, seed=C, C=C)
    x = (x[1:] if misaligned else x[:-1]).view(4099, C)
    if not misaligned:
        assert tln.vector_loads(x, w, b, tln.rows_of(x)[1]) == ((C * x.element_size()) % 16 == 0)
    _ln_check(x, w, b)


@pytest.mark.gpu
def test_layer_norm_wrapper_rejects_mixed_devices_on_card(cuda):
    x, w, b = _ln_case(cuda, (4, 288), torch.bfloat16)
    with pytest.raises(ValueError):
        tln.fused_layer_norm(x, w.cpu(), b, 1e-5)


@pytest.mark.gpu
def test_layer_norm_module_on_card_launches_outside_autograd(cuda):
    ln = tlayers.LayerNorm(288).to(cuda)
    ln.impl = "pallas"
    x = torch.randn(2, 7, 288, device=cuda, dtype=torch.bfloat16)
    launches, calls = tln.launches, tlayers.plain_calls
    with torch.no_grad():
        ln(x)
    assert (tln.launches, tlayers.plain_calls) == (launches + 1, calls)
    ln(x).sum().backward()  # parameters require grad: the plain version
    assert (tln.launches, tlayers.plain_calls) == (launches + 1, calls + 1)
    assert ln.weight.grad is not None


def _rel(a, b, xyz=False):
    a, b = a.double(), b.double()
    if xyz:  # centred on b's centroid
        c = b.reshape(-1, 3).mean(0)
        a, b = a - c, b - c
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# a fast_config(160) forward with kernel LN against plain LayerNorms, each
# stage from the kernel run's inputs (`_ln_stage_gaps`): three times the
# largest relative gap of weight seeds 0-4 on an H100 (PERF.md §6);
# `head` is the prediction head's projection, `logits` the whole head
LN_STAGE_LIMITS = {"msa": 9.8e-3, "pair": 2.2e-2, "xyz0": 4.2e-3, "state": 3.1e-6,
                   "xyz": 2.1e-6, "msa_fb": 5.9e-4, "head": 1.1e-4, "logits": 2.3e-2}


def _ln_stage_gaps(cuda, seed):
    """{stage output: largest relative gap} of a bf16 fast_config(160)
    forward with kernel LN against the same weights with every LayerNorm
    plain, each stage run again from the kernel run's inputs; asserts that
    every LayerNorm call of the kernel run launched kernel LN."""
    from rosettafold_tpu_torch.data.a3m import load_a3m, msa_features
    from rosettafold_tpu_torch.models import heads as theads, msa as tmsa

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = build_model(fast_config(160), device=cuda, seed=seed)
    msa, seq, aa = (torch.as_tensor(a, device=cuda) for a in msa_features(
        load_a3m(os.path.join(root, "examples", "demo_casp.a3m")), n_seq=64, crop_len=160))
    keys = {tstruct.InitialCoordGenerationWithMsaAndPair: ("xyz0",),
            tstruct.CoordUpdateWithMsaAndPair: ("state", "xyz"),
            tmsa.MsaUpdateWithPairAndCoord: ("msa_fb",),
            theads.PredictionHead: ("head", "logits")}
    stages, hooks, ln_calls = [], [], [0]
    for mod in model.modules():
        if isinstance(mod, tlayers.LayerNorm):
            hooks.append(mod.register_forward_pre_hook(
                lambda *_: ln_calls.__setitem__(0, ln_calls[0] + 1)))
        k = ("msa", "pair") if type(mod).__name__ == "TwoTrackBlock" else keys.get(type(mod))
        if k:
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, k=k: stages.append((m, k, args))))

    def run(mod, args):
        """The stage's outputs in the order of its keys."""
        out = mod(*args)
        if isinstance(mod, theads.PredictionHead):
            return [mod.proj(mod.proj_ln(*args)), torch.cat([v.flatten() for v in out.values()])]
        return list(out) if isinstance(out, tuple) else [out]

    gaps = {}
    with torch.inference_mode():
        launches, calls = tln.launches, tlayers.plain_calls
        model(msa, seq, aa)
        torch.cuda.synchronize()
        assert ln_calls[0] > 0 and tln.launches - launches == ln_calls[0]
        assert tlayers.plain_calls == calls
        for h in hooks:
            h.remove()
        assert len(stages) == 3 + 1 + 3 * 3 + 2 + 1
        got = [run(m, a) for m, _, a in stages]
        for m in model.modules():
            if isinstance(m, tlayers.LayerNorm):
                m.impl = "xla"
        for (mod, k, args), outs in zip(stages, got):
            for key, o, w_ in zip(k, outs, run(mod, args)):
                gap = _rel(o, w_, xyz=key.startswith("xyz"))
                gaps[key] = max(gaps.get(key, 0.0), gap)
    return gaps


@pytest.mark.gpu
def test_layer_norm_kernel_model_within_stage_limits_on_card(cuda):
    """fast_config(160) with kernel LN against the same weights with every
    LayerNorm plain, stage by stage from the kernel run's inputs, within
    limits read from this comparison (LN_STAGE_LIMITS); every LayerNorm call
    of the forward launches the kernel."""
    gaps = _ln_stage_gaps(cuda, 0)
    for key, limit in LN_STAGE_LIMITS.items():
        assert gaps[key] <= limit, (key, gaps[key], limit)
