"""Each ported module against its flax counterpart: one flax init, weights
carried over by the bridge's leaf rules, the same numpy inputs, float32,
dropout off, within 1e-4. Kernel call sites run on the CPU: the port through
its kernels' plain versions, JAX through Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rosettafold_tpu.models import attention as jattn
from rosettafold_tpu.models import embeddings as jemb
from rosettafold_tpu.models import heads as jheads
from rosettafold_tpu.models import msa as jmsa
from rosettafold_tpu.models import pair as jpair
from rosettafold_tpu.models import resnet as jresnet
from rosettafold_tpu.models import rosettafold as jrf
from rosettafold_tpu.models import se3 as jse3
from rosettafold_tpu.models import structure as jstruct
from rosettafold_tpu.ops import knn as jknn
from rosettafold_tpu.ops import so3 as jso3
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch.models import attention as tattn
from rosettafold_tpu_torch.models import embeddings as temb
from rosettafold_tpu_torch.models import heads as theads
from rosettafold_tpu_torch.models import msa as tmsa
from rosettafold_tpu_torch.models import pair as tpair
from rosettafold_tpu_torch.models import resnet as tresnet
from rosettafold_tpu_torch.models import rosettafold as trf
from rosettafold_tpu_torch.models import se3 as tse3
from rosettafold_tpu_torch.models import structure as tstruct
from tests.port_utils import random_params

TOL = 1e-4
B, N, L = 1, 3, 12
D_MSA, D_PAIR = 24, 16


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, seed=0, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _compare(t_out, j_out, tol=TOL, path="out"):
    if isinstance(j_out, dict):
        assert set(t_out) == set(j_out), path
        for k in j_out:
            _compare(t_out[k], j_out[k], tol, f"{path}[{k}]")
    elif isinstance(j_out, (tuple, list)):
        assert len(t_out) == len(j_out), path
        for i, (a, b) in enumerate(zip(t_out, j_out)):
            _compare(a, b, tol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                                   atol=tol, rtol=tol, err_msg=path)


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def check(jmod, tmod, *args, tol=TOL):
    """Random params for jmod, loaded into tmod; run both, compare."""
    params = random_params(jmod, *args)
    j_out = jax.jit(jmod.apply)(params, *args)
    tmod.load_state_dict(bridge.module_state_dict(params), strict=True)
    tmod.eval()
    with torch.no_grad():
        t_out = tmod(*[_torch(a) for a in args])
    _compare(t_out, j_out, tol)
    return t_out


def _tokens(shape, seed=0):
    return _rng(seed).integers(0, 21, shape).astype(np.int32)


AA = np.arange(L, dtype=np.int32)[None]


def test_msa_embedding():
    check(jemb.MsaEmbedding(d_msa=D_MSA, max_len=64), temb.MsaEmbedding(d_msa=D_MSA, max_len=64),
          _tokens((B, N, L)), AA)


def test_pair_embedding():
    check(jemb.PairEmbedding(d_pair=D_PAIR, max_len=64),
          temb.PairEmbedding(d_pair=D_PAIR, max_len=64), _tokens((B, L)), AA)


def test_sinusoidal_positional_encodings():
    aa = AA + 3
    check(jemb.SinusoidalPositionalEncoding(D_MSA, 64),
          temb.SinusoidalPositionalEncoding(D_MSA, 64), _normal((B, N, L, D_MSA)), aa)
    check(jemb.SinusoidalPositionalEncoding2D(D_PAIR, 64),
          temb.SinusoidalPositionalEncoding2D(D_PAIR, 64), _normal((B, L, L, D_PAIR)), aa)


def test_feed_forward():
    check(jattn.FeedForward(D_MSA, 2 * D_MSA), tattn.FeedForward(D_MSA, 2 * D_MSA),
          _normal((B, L, D_MSA)))


@pytest.mark.parametrize("generalized,attend_axis", [(False, -2), (True, -2), (True, 1)])
def test_performer_self_attention(generalized, attend_axis):
    """Softmax and ReLU FAVOR+ features, over axis -2 and (the row step of the
    axial stack) over axis 1 of a 4D input."""
    kw = dict(dim=D_PAIR, heads=2, dim_head=8, generalized_attention=generalized,
              attend_axis=attend_axis, feature_seed=7)
    check(jattn.PerformerSelfAttention(**kw), tattn.PerformerSelfAttention(**kw),
          _normal((B, L, L - 2, D_PAIR)))


@pytest.mark.parametrize("kind", ["tied", "performer"])
def test_encoder_layer(kind):
    kw = dict(d_msa=D_MSA, d_ff=2 * D_MSA, n_heads=4, performer_dim_head=8,
              attn_impl="pallas", **{kind: True})
    check(jmsa.EncoderLayer(**kw), tmsa.EncoderLayer(**kw), _normal((B, N, L, D_MSA)))


def test_positionwise_weight_factor():
    check(jmsa.PositionWiseWeightFactor(D_MSA, 4), tmsa.PositionWiseWeightFactor(D_MSA, 4),
          _normal((B, N, L, D_MSA)))


@pytest.mark.parametrize("impl,return_att", [("xla", True), ("pallas", False)])
def test_soft_tied_attention(impl, return_att):
    kw = dict(d_msa=D_MSA, n_heads=4, return_att=return_att, attn_impl=impl)
    check(jmsa.SoftTiedAttentionOverResidues(**kw), tmsa.SoftTiedAttentionOverResidues(**kw),
          _normal((B, N, L, D_MSA)))


def test_msa_update_using_self_attention():
    kw = dict(d_msa=D_MSA, d_ff=2 * D_MSA, n_heads=4, n_encoder_layers=2,
              performer_dim_head=8, attn_impl="pallas")
    check(jmsa.MsaUpdateUsingSelfAttention(**kw), tmsa.MsaUpdateUsingSelfAttention(**kw),
          _normal((B, N, L, D_MSA)))


def test_msa_update_with_pair():
    kw = dict(d_msa=D_MSA, d_pair=D_PAIR, n_heads=4, n_encoder_layers=2)
    check(jmsa.MsaUpdateWithPair(**kw), tmsa.MsaUpdateWithPair(**kw),
          _normal((B, N, L, D_MSA)), _normal((B, L, L, D_PAIR), 1))


def test_msa_update_with_pair_and_coord():
    kw = dict(d_msa=D_MSA, d_state=8, d_ff=2 * D_MSA)
    check(jmsa.MsaUpdateWithPairAndCoord(**kw), tmsa.MsaUpdateWithPairAndCoord(**kw),
          _normal((B, L, 3, 3), 2, 6.0), _normal((B, L, 8), 3), _normal((B, N, L, D_MSA)))


def test_symmetrize_and_outer_product_mean():
    x = _normal((B, L, L, 5))
    np.testing.assert_allclose(tpair.symmetrize(torch.from_numpy(x)).numpy(),
                               np.asarray(jpair.symmetrize(jnp.asarray(x))), atol=1e-7)
    check(jpair.OuterProductMean(8, D_PAIR), tpair.OuterProductMean(8, D_PAIR),
          _normal((B, N, L, 8)), _normal((B, N, L, 8), 1))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pair_update_with_msa(impl):
    kw = dict(d_msa=D_MSA, d_proj=8, d_pair=D_PAIR, n_heads=4, attn_impl=impl)
    check(jpair.PairUpdateWithMsa(**kw), tpair.PairUpdateWithMsa(**kw),
          _normal((B, N, L, D_MSA)), _normal((B, L, L, D_PAIR), 1),
          np.abs(_normal((B, L, L, 4), 2)))


@pytest.mark.parametrize("impl,length", [("xla", 8), ("pallas", 8), ("pallas", 12)])
def test_pair_update_with_axial_attention(impl, length):
    """Lengths 8 and 12 take the quadratic and linear FAVOR+ associations."""
    kw = dict(d_pair=D_PAIR, d_ff=2 * D_PAIR, n_heads=2, n_encoder_layers=2,
              performer_dim_head=8, attn_impl=impl)
    check(jpair.PairUpdateWithAxialAttention(**kw), tpair.PairUpdateWithAxialAttention(**kw),
          _normal((B, length, length, D_PAIR)))


@pytest.mark.parametrize("dilation", [1, 2])
def test_res_block_2d(dilation):
    check(jresnet.ResBlock2D(8, dilation=dilation), tresnet.ResBlock2D(8, dilation=dilation),
          _normal((B, L, L, 8)))


def test_resnet_and_prediction_head():
    check(jresnet.ResNet(2, 8, 8, 5), tresnet.ResNet(2, 8, 8, 5), _normal((B, L, L, 8)))
    check(jheads.PredictionHead(in_channels=8, n_res_blocks=2),
          theads.PredictionHead(8, n_res_blocks=2), _normal((B, L, L, 8), 1))


def test_graph_transformer_block_and_sequence_separation():
    aa = AA * 3  # spaced numbering: separations beyond the unit steps
    np.testing.assert_allclose(
        tstruct.signed_sequence_separation(torch.from_numpy(aa)).numpy(),
        np.asarray(jstruct.signed_sequence_separation(jnp.asarray(aa))), atol=1e-6)
    check(jstruct.GraphTransformerBlock(8, 8, 6, 2), tstruct.GraphTransformerBlock(8, 8, 6, 2),
          _normal((B, L, 8)), _normal((B, L, L, 6), 1))


def test_initial_coord_generation():
    kw = dict(d_msa=D_MSA, d_pair=D_PAIR, d_node=8, d_edge=8)
    seq1h = np.eye(21, dtype=np.float32)[_tokens((B, L))]
    check(jstruct.InitialCoordGenerationWithMsaAndPair(**kw),
          tstruct.InitialCoordGenerationWithMsaAndPair(**kw),
          _normal((B, N, L, D_MSA)), _normal((B, L, L, D_PAIR), 1), seq1h, AA)


def _se3_inputs(l0=8, edge=8, seed=0):
    xyz = _normal((B, L, 3, 3), seed, 5.0)
    ca = xyz[:, :, 1]
    rel = ca[:, :, None, :] - ca[:, None, :, :]
    mask = np.asarray(jknn.incoming_mask(jknn.knn_adjacency(
        jnp.asarray(xyz), jnp.asarray(AA), 4)))
    return (_normal((B, L, l0, 1), seed + 1), _normal((B, L, 3, 3), seed + 2),
            _normal((B, L, L, edge), seed + 3), rel.astype(np.float32), mask)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_se3_transformer(impl):
    kw = dict(num_layers=2, num_channels=8, n_heads=2, num_degrees=2, l0_in_features=8,
              l1_in_features=3, l0_out_features=8, l1_out_features=3,
              num_edge_features=8, impl=impl)
    check(jse3.SE3Transformer(**kw), tse3.SE3Transformer(**kw), *_se3_inputs())


def test_gse3res_and_gnormbias():
    h0, h1, edge, rel, mask = _se3_inputs()
    basis = jso3.equivariant_basis(jnp.asarray(rel), 1)
    feat = np.concatenate([edge, np.asarray(jso3.edge_radii(jnp.asarray(rel)))], -1)
    h = {0: h0, 1: h1}
    f_in, f_out = jse3.Fiber({0: 8, 1: 3}), jse3.Fiber({0: 8, 1: 8})
    jmod = jse3.GSE3Res(f_in, f_out, edge_dim=8, div=2, n_heads=2)
    tmod = tse3.GSE3Res(tse3.Fiber({0: 8, 1: 3}), tse3.Fiber({0: 8, 1: 8}), 8, 2, 2)
    out = check(jmod, tmod, h, feat, basis, mask)
    norm_j = jse3.GNormBias(f_out)
    norm_t = tse3.GNormBias(tse3.Fiber({0: 8, 1: 8}))
    check(norm_j, norm_t, {d: v.numpy() for d, v in out.items()})


def test_coord_update_with_msa_and_pair():
    kw = dict(d_msa=D_MSA, d_pair=D_PAIR, d_node=8, d_edge=8, d_state=8, n_neighbors=6,
              attn_impl="pallas")
    seq1h = np.eye(21, dtype=np.float32)[_tokens((B, L))]
    check(jstruct.CoordUpdateWithMsaAndPair(**kw), tstruct.CoordUpdateWithMsaAndPair(**kw),
          _normal((B, L, 3, 3), 2, 5.0), _normal((B, N, L, D_MSA)),
          _normal((B, L, L, D_PAIR), 1), AA, seq1h)


def test_two_track_block():
    kw = dict(d_msa=D_MSA, d_pair=D_PAIR, n_encoder_layers=1, attn_impl="pallas")
    check(jrf.TwoTrackBlock(**kw), trf.TwoTrackBlock(**kw),
          _normal((B, N, L, D_MSA)), _normal((B, L, L, D_PAIR), 1))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_se3_transformer_rotation_equivariance(impl):
    """Rotating coordinates and type-1 inputs by R leaves the type-0 output
    unchanged and rotates the type-1 output by R (as tests/test_se3.py)."""
    from rosettafold_tpu_torch.models.rosettafold import init_like_flax

    model = tse3.SE3Transformer(num_layers=2, num_channels=8, n_heads=2, num_degrees=2,
                                l0_in_features=8, l1_in_features=3, l0_out_features=8,
                                l1_out_features=3, num_edge_features=8, impl=impl)
    init_like_flax(model, torch.Generator().manual_seed(0))
    h0, h1, edge, rel, mask = map(_torch, _se3_inputs())
    edge = 0.5 * (edge + edge.transpose(1, 2))
    q, _ = np.linalg.qr(_rng(5).normal(size=(3, 3)))
    R = torch.from_numpy((q * np.sign(np.linalg.det(q))).astype(np.float32))
    with torch.no_grad():
        out = model(h0, h1, edge, rel, mask)
        out_r = model(h0, h1 @ R.T, edge, rel @ R.T, mask)
    np.testing.assert_allclose(out_r[0].numpy(), out[0].numpy(), atol=2e-3)
    np.testing.assert_allclose(out_r[1].numpy(), (out[1] @ R.T).numpy(), atol=2e-3)


# ---- kernel mode (kernels C, D, E, F) at L = 16 through the crossover fields;
# JAX runs its Pallas kernels in interpret mode, the port their plain versions
LK = 16


def test_axial_layer_kernel_mode():
    """Row and column steps through kernel C with LN and residual folded in,
    the FF step through kernel D."""
    kw = dict(d_pair=D_PAIR, d_ff=2 * D_PAIR, n_heads=2, performer_dim_head=8,
              attn_impl="pallas", fused_favor_min_l=1, ff_fused_min_l=1, p_dropout=0.0)
    tmod = tpair.PairUpdateWithAxialAttentionLayer(**kw)
    assert tmod.row_attn.fused_favor_min_l == 1 and tmod.ff_fused_min_l == 1
    check(jpair.PairUpdateWithAxialAttentionLayer(**kw), tmod,
          _normal((B, LK, LK, D_PAIR)))


def test_outer_product_mean_kernel_mode():
    check(jpair.OuterProductMean(8, D_PAIR, impl="pallas", fused_min_l=1),
          tpair.OuterProductMean(8, D_PAIR, impl="pallas", fused_min_l=1),
          _normal((B, N, LK, 8)), _normal((B, N, LK, 8), 1))


def test_pair_update_with_msa_kernel_mode():
    kw = dict(d_msa=D_MSA, d_proj=8, d_pair=D_PAIR, n_heads=4, attn_impl="pallas",
              conv_fused_min_l=1)
    check(jpair.PairUpdateWithMsa(**kw), tpair.PairUpdateWithMsa(**kw),
          _normal((B, N, LK, D_MSA)), _normal((B, LK, LK, D_PAIR), 1),
          np.abs(_normal((B, LK, LK, 4), 2)))


@pytest.mark.parametrize("dilation", [1, 4])
def test_res_block_2d_kernel_mode(dilation):
    kw = dict(dilation=dilation, conv_impl="pallas", fused_min_l=1)
    check(jresnet.ResBlock2D(8, **kw), tresnet.ResBlock2D(8, **kw), _normal((B, LK, LK, 8)))


def test_prediction_head_kernel_mode():
    """Every tower block through kernel F (the port's blocks set to engage at
    L = 16) against the JAX head, whose towers cannot lower their crossover
    and so run the XLA convs: the same math in float32."""
    tmod = theads.PredictionHead(8, n_res_blocks=2, conv_impl="pallas")
    blocks = [m for m in tmod.modules() if isinstance(m, tresnet.ResBlock2D)]
    assert len(blocks) == 8
    for blk in blocks:
        blk.fused_min_l = 1
    check(jheads.PredictionHead(in_channels=8, n_res_blocks=2, conv_impl="pallas"), tmod,
          _normal((B, LK, LK, 8), 1))
