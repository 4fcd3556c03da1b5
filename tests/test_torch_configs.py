"""The port's remaining serving configurations against JAX: the exact
`scatter` SE(3) layout, the `long_chunk` row-chunked outer product and axial
attention, the template input, and JAX checkpoints converted by
`convert_jax_params.py` and served through `predict --params`. Float32,
dropout off, the same numpy inputs and one flax parameter tree on both sides,
within 1e-4 unless a test states otherwise."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_params
from rosettafold_tpu import predict as jpredict
from rosettafold_tpu import tiny_config
from rosettafold_tpu import train_cli as jtrain_cli
from rosettafold_tpu.models import attention as jattn
from rosettafold_tpu.models import embeddings as jemb
from rosettafold_tpu.models import pair as jpair
from rosettafold_tpu.models import structure as jstruct
from rosettafold_tpu.models.rosettafold import RoseTTAFold as JaxRoseTTAFold
from rosettafold_tpu.train import checkpoint as jckpt
from rosettafold_tpu.utils.scan_convert import adapt_params
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch import predict as tpredict
from rosettafold_tpu_torch.models import attention as tattn
from rosettafold_tpu_torch.models import embeddings as temb
from rosettafold_tpu_torch.models import pair as tpair
from rosettafold_tpu_torch.models import structure as tstruct
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold
from rosettafold_tpu_torch.ops import knn as tknn
from rosettafold_tpu_torch.ops.cuda import se3_attend as tatt
from tests.port_utils import port_config, random_params

TOL = 1e-4
L = 20  # rows chunked by 8: chunks 8, 8, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torch(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=tol)


def _port(jmod, tmod, *args):
    """jmod's random params (numpy draws) and the same loaded into tmod."""
    params = random_params(jmod, *args)
    tmod.load_state_dict(bridge.module_state_dict(params), strict=True)
    return params, tmod.eval()


# ------------------------------------------------------------ scatter layout


def _no_kernel_b(*args, **kw):
    """Stands in for kernel B's wrapper, which the scatter layout never calls."""
    raise AssertionError("kernel B called on the scatter layout")


def _coord_inputs(K=6):
    """A random-walk backbone with one residue far from the rest and every
    sequence separation >= 9 (no band edges): that residue is in no other
    residue's top-K, so as a destination its segment is empty."""
    rng = np.random.default_rng(0)
    xyz = np.cumsum(rng.normal(size=(1, L, 1, 3)) * 2.2, axis=1) + rng.normal(size=(1, L, 3, 3))
    xyz[:, 7] += 1e3
    aa = (10 * np.arange(L, dtype=np.int32))[None]
    idx, valid = tknn.knn_gather_indices(_torch(xyz.astype(np.float32)), _torch(aa), K)
    assert 7 not in set(idx[valid].tolist())
    return (xyz.astype(np.float32), rng.normal(size=(1, 3, L, 16)).astype(np.float32),
            rng.normal(size=(1, L, L, 8)).astype(np.float32), aa,
            np.eye(21, dtype=np.float32)[rng.integers(0, 21, (1, L))])


def _coord_kw(impl, attn="pallas"):
    return dict(d_msa=16, d_pair=8, d_node=8, d_edge=8, d_state=8, n_neighbors=6,
                p_dropout=0.0, attn_impl=attn, se3_impl=impl)


@pytest.mark.parametrize("k_dynamic", [None, 3])
def test_coord_update_scatter_matches_jax(k_dynamic, monkeypatch):
    """CoordUpdateWithMsaAndPair on the scatter layout against JAX's, with and
    without the scanned blocks' k_dynamic, with an empty destination segment.
    attn_impl="pallas" as served: both run the plain segment ops (kernel B
    is never called on this layout)."""
    args = _coord_inputs()
    jmod = jstruct.CoordUpdateWithMsaAndPair(**_coord_kw("scatter"))
    tmod = tstruct.CoordUpdateWithMsaAndPair(**_coord_kw("scatter"), k_dynamic=k_dynamic)
    params, tmod = _port(jmod, tmod, *args)
    kd = None if k_dynamic is None else jnp.asarray(k_dynamic)
    j_state, j_xyz = jax.jit(lambda p, *a: jmod.apply(p, *a, k_dynamic=kd))(params, *args)
    monkeypatch.setattr(tatt, "gse3_attend", _no_kernel_b)
    with torch.no_grad():
        t_state, t_xyz = tmod(*map(_torch, args))
    _close(t_state, j_state)
    _close(t_xyz, j_xyz)


def test_coord_update_scatter_matches_dense():
    """The scatter layout holds the dense layout's exact edge set: the port's
    two paths agree within JAX's own bound for this check, 2e-4
    (tests/test_se3.py::test_gather_vs_dense_divergence_at_small_K)."""
    args = _coord_inputs()
    scatter = tstruct.CoordUpdateWithMsaAndPair(**_coord_kw("scatter", "xla"))
    _, scatter = _port(jstruct.CoordUpdateWithMsaAndPair(**_coord_kw("scatter", "xla")),
                       scatter, *args)
    dense = tstruct.CoordUpdateWithMsaAndPair(**_coord_kw("dense", "xla"))
    dense.load_state_dict(scatter.state_dict())
    with torch.no_grad():
        (s_s, x_s), (s_d, x_d) = (m.eval()(*map(_torch, args)) for m in (scatter, dense))
    torch.testing.assert_close(s_s, s_d, atol=2e-4, rtol=0)
    torch.testing.assert_close(x_s, x_d, atol=2e-4, rtol=0)


# --------------------------------------------------------------- long_chunk


@pytest.mark.parametrize("chunk", [8, 32])
def test_outer_product_mean_chunked_matches_jax(chunk):
    """chunk_size 8 at L = 20 (a last chunk of 4), and 32 >= L (one chunk)."""
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(1, 3, L, 6)).astype(np.float32) for _ in range(2))
    jmod = jpair.OuterProductMean(6, 8, chunk_size=chunk)
    params, tmod = _port(jmod, tpair.OuterProductMean(6, 8, chunk_size=chunk), x, y)
    with torch.no_grad():
        _close(tmod(_torch(x), _torch(y)), jax.jit(jmod.apply)(params, x, y))


@pytest.mark.parametrize("axis,ln", [(-2, False), (1, False), (1, True)])
def test_performer_chunk_rows_matches_jax(axis, ln):
    """chunk_rows 8 over 20 rows on both axes of the generalized FAVOR+ layer,
    and with ln_params (the residual and LN applied around the chunks)."""
    kw = dict(dim=8, heads=2, dim_head=4, generalized_attention=True, chunk_rows=8,
              attend_axis=axis)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, L, L, 8)).astype(np.float32)
    jmod = jattn.PerformerSelfAttention(**kw)
    params, tmod = _port(jmod, tattn.PerformerSelfAttention(**kw), x)
    g = (1.0 + 0.1 * rng.normal(size=8)).astype(np.float32)
    b = (0.1 * rng.normal(size=8)).astype(np.float32)
    lnp = (g, b, 1e-5) if ln else None
    j_out = jax.jit(lambda p, x: jmod.apply(p, x, ln_params=lnp))(params, x)
    with torch.no_grad():
        t_out = tmod(_torch(x), ln_params=(_torch(g), _torch(b), 1e-5) if ln else None)
    _close(t_out, j_out)


# ------------------------------------------------------------------ template


def test_pair_embedding_template_matches_jax():
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 21, (1, L)).astype(np.int32)
    aa = np.arange(L, dtype=np.int32)[None]
    tpl = rng.normal(size=(1, L, L, 64)).astype(np.float32) * 3.0
    kw = dict(d_pair=16, max_len=64, use_template=True)
    jmod = jemb.PairEmbedding(**kw)
    params, tmod = _port(jmod, temb.PairEmbedding(**kw), seq, aa, tpl)
    assert tuple(tmod.proj.weight.shape) == (16, 16 + 1 + 64)
    j_out = jax.jit(jmod.apply)(params, seq, aa, tpl)
    with torch.no_grad():
        _close(tmod(_torch(seq), _torch(aa), _torch(tpl)), j_out)


@pytest.mark.parametrize("use_template", [False, True])
def test_pair_embedding_template_mismatch_raises(use_template):
    """JAX's two errors, with its messages: a template without use_template,
    and use_template without a template."""
    mod = temb.PairEmbedding(d_pair=16, max_len=64, use_template=use_template)
    seq, aa = torch.zeros(1, 4, dtype=torch.long), torch.arange(4)[None]
    tpl = None if use_template else torch.zeros(1, 4, 4, 64)
    what = "requires template" if use_template else "template is not None but use_template"
    with pytest.raises(ValueError, match=what):
        mod(seq, aa, tpl)


# -------------------------------------------------------------- whole model


def test_slice_scatter_template_long_chunk_matches_jax(monkeypatch):
    """tiny_config(attn_impl="pallas", scan_blocks=True) with the scatter
    layout, a template and long_chunk 8 at L = 20, in one JAX compile,
    against the port through the bridge (the template's LN and the wider
    proj map by the leaf rules; scatter and long_chunk add no parameter);
    kernel B is never called."""
    cfg = tiny_config(attn_impl="pallas", scan_blocks=True, se3_impl="scatter",
                      use_template=True, long_chunk=8, p_dropout=0.0)
    rng = np.random.default_rng(4)
    msa = rng.integers(0, 21, (1, 3, L)).astype(np.int32)
    inputs = (msa, msa[:, 0], np.arange(L, dtype=np.int32)[None],
              rng.normal(size=(1, L, L, cfg.d_template)).astype(np.float32))
    params = random_params(JaxRoseTTAFold(config=cfg), *inputs)
    j = jax.jit(JaxRoseTTAFold(config=cfg).apply)(params, *inputs)
    tcfg = port_config(cfg)
    model = RoseTTAFold(tcfg, init=False)
    model.load_state_dict(bridge.state_dict_from_flax(params, tcfg), strict=True)
    monkeypatch.setattr(tatt, "gse3_attend", _no_kernel_b)
    with torch.no_grad():
        logits, xyz, plddt = model(*map(torch.from_numpy, inputs))
    for k in j[0]:
        _close(logits[k], j[0][k])
    _close(xyz, j[1])
    _close(plddt, j[2])


# ------------------------------------------------------- JAX checkpoints


def _serving_config():
    """train_cli's tiny preset (the converter's --preset tiny), served in
    float32 without remat: the same parameter tree."""
    return dataclasses.replace(jtrain_cli.preset_config("tiny", 24), compute_dtype="float32",
                               remat=False)


CROP, N_SEQ = 24, 4
A3M = os.path.join(REPO, "examples", "demo_casp.a3m")


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """One parameter tree saved with `rosettafold_tpu.train.checkpoint.save`
    under <dir>/latest, as `train_cli --ckpt-dir` leaves it: bare unscanned
    variables, and a TrainState with the blocks stacked (scanned); the bare
    variables also as the msgpack file of that module's fallback; and JAX's
    `predict` served from the first."""
    import optax
    from flax import serialization
    from flax.training import train_state

    cfg = _serving_config()
    msa = np.zeros((1, N_SEQ, CROP), np.int32)
    variables = random_params(JaxRoseTTAFold(config=cfg), msa, msa[:, 0],
                              np.arange(CROP, dtype=np.int32)[None], seed=5)
    root = tmp_path_factory.mktemp("jax_ckpt")
    dirs = {k: str(root / k) for k in ("unscanned", "scanned", "msgpack")}
    jckpt.save(os.path.join(dirs["unscanned"], "latest"), variables)
    os.makedirs(os.path.join(dirs["msgpack"], "latest"))
    with open(os.path.join(dirs["msgpack"], "latest", "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(variables))
    scanned = adapt_params(variables, want_scanned=True)["params"]
    assert "two_track_scan" in scanned and "three_track_scan" in scanned
    state = train_state.TrainState.create(apply_fn=None, params=scanned, tx=optax.adamw(1e-3))
    jckpt.save(os.path.join(dirs["scanned"], "latest"), state)
    out = jpredict.predict(A3M, params_path=dirs["unscanned"], n_seq=N_SEQ, crop=CROP,
                           config=cfg)
    return dirs, out


@pytest.mark.parametrize("layout", ["unscanned", "scanned", "msgpack"])
def test_converted_checkpoint_serves_like_jax(layout, jax_checkpoints, tmp_path, capsys):
    """convert_jax_params.py (its CLI, --preset tiny) turns each checkpoint
    into a state_dict; the port's predict serves it within 1e-4 of JAX's
    predict on the same A3M (crop 24, n_seq 4)."""
    dirs, (j_logits, j_xyz, j_plddt, (msa, _, _), _) = jax_checkpoints
    out = str(tmp_path / "params.pt")
    convert_jax_params.main(["--ckpt-dir", dirs[layout], "--out", out, "--preset", "tiny"])
    assert out in capsys.readouterr().out
    logits, xyz, plddt, (t_msa, _, _), _ = tpredict.predict(
        A3M, params_path=out, n_seq=N_SEQ, crop=CROP, config=port_config(_serving_config()),
        device="cpu")
    np.testing.assert_array_equal(t_msa, msa)
    for k in j_logits:
        _close(logits[k], j_logits[k])
    _close(xyz, j_xyz)
    _close(plddt, j_plddt)
