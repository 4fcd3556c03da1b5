"""The port's kernels A (tied attention) and B (dense SE(3) attend).

On the CPU the wrappers run their plain PyTorch versions, which are held here
against the JAX functions (Pallas interpret mode, or the file's own plain
reference). The kernels themselves compile and run only on a CUDA card: the
tests marked `gpu` compare them with the plain versions there and skip here.
The card's machine has no JAX, so they need none; run them there with
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch.models import se3 as tse3
from rosettafold_tpu_torch.models.rosettafold import init_like_flax
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops import so3 as tso3
from rosettafold_tpu_torch.ops.cuda import se3_attend as tatt
from rosettafold_tpu_torch.ops.cuda import tied_attention as ttied

try:  # the JAX reference: present on the CPU test host, absent beside the card
    import jax
    import jax.numpy as jnp

    from rosettafold_tpu.models import se3 as jse3
    from rosettafold_tpu.ops import knn as jknn
    from rosettafold_tpu.ops import so3 as jso3
    from rosettafold_tpu.ops.pallas import se3_attend as jatt
    from rosettafold_tpu.ops.pallas import tied_attention as jtied
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
    c = _se3_case("res_1", L=8)
    T = _writable
    h = {d: T(v[:, :5]) for d, v in c["h"].items()}  # S != L: not the dense layout
    with pytest.raises(ValueError):
        tatt.gse3_attend(T(c["feat"]), {k: T(v) for k, v in c["basis"].items()}, h,
                         T(c["mask"]), T(c["qh"]),
                         tatt.stack_weights(c["tmod"].v, c["tmod"].k, c["tmod"].meta),
                         c["tmod"].meta)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TIED_CASES + [(48, 120, 2048, 2048)])
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
