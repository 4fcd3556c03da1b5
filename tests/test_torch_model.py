"""The port's whole slice against JAX: `tiny_config(scan_blocks=True,
attn_impl="pallas")` through one JAX parameter tree shared by the module's
tests (JAX runs its Pallas kernels in interpret mode, the port its kernels'
plain versions on the CPU), in float32 and in the bf16 trunk, at L = 16
(kernels A, B) and at L = 128 (all six kernels); the bridge's scan
unstacking; the fast preset's range; and the port's predict CLI. Each side
gets its own config class, the port's built from the JAX one's fields."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rosettafold_tpu import tiny_config
from rosettafold_tpu.models.rosettafold import RoseTTAFold as JaxRoseTTAFold
from rosettafold_tpu.utils.scan_convert import adapt_params
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch import predict as tpredict
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold
from tests.port_utils import port_config, random_params

B, N, L = 1, 4, 16
CFG = tiny_config(scan_blocks=True, attn_impl="pallas", p_dropout=0.0)
# L = 128: every pair-track kernel engages. One encoder layer (tiny_config's
# own depth) keeps the JAX interpret-mode run on the CPU within a minute.
L_KERNELS = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    msa = rng.integers(0, 21, (B, N, L)).astype(np.int32)
    inputs = (msa, msa[:, 0], np.arange(L, dtype=np.int32)[None])
    # the JAX model's parameter tree from its abstract init (no compile),
    # filled from a numpy seed with non-zero biases
    return random_params(JaxRoseTTAFold(config=CFG), *inputs), inputs


def _outputs(cfg, params, inputs):
    j = jax.jit(JaxRoseTTAFold(config=cfg).apply)(params, *inputs)
    tcfg = port_config(cfg)
    model = RoseTTAFold(tcfg, init=False)
    model.load_state_dict(bridge.state_dict_from_flax(params, tcfg), strict=True)
    with torch.no_grad():
        t = model(*[torch.from_numpy(a) for a in inputs])
    flat = lambda out: [np.asarray(x, np.float32) for x in  # noqa: E731
                        [*(out[0][k] for k in sorted(out[0])), out[1], out[2]]]
    return flat(j), flat(t)


def test_slice_float32_matches_jax(jax_model):
    params, inputs = jax_model
    j, t = _outputs(CFG, params, inputs)
    for a, b in zip(t, j):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_slice_bfloat16_matches_jax(jax_model):
    """bf16 trunk on both sides (LN/softmax statistics and SE(3) in f32). The
    frameworks round bf16 products at different places, so the bound is
    statistical: the JAX package's own bf16 check (tests/test_model.py,
    xyz corr > 0.98 against f32) applied to xyz and every logit map. plDDT,
    which that check leaves out, has only L = 16 values here: its bound is
    on the largest difference instead (measured 0.13 on this host)."""
    params, inputs = jax_model
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    j, t = _outputs(cfg, params, inputs)
    for a, b in zip(t[:-1], j[:-1]):  # logits (4 maps) and xyz
        assert np.isfinite(a).all()
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.98
    assert np.isfinite(t[-1]).all() and np.abs(t[-1] - j[-1]).max() < 0.25


def test_bridge_unstacks_like_adapt_params(jax_model):
    params, _ = jax_model
    ours = bridge.unstack_scanned(params["params"])
    theirs = adapt_params(params, want_scanned=False)["params"]
    la, ta = jax.tree_util.tree_flatten_with_path(ours)
    lb, tb = jax.tree_util.tree_flatten_with_path(theirs)
    assert ta == tb
    for (pa, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(pa))


def test_bridge_loads_strictly(jax_model):
    params, _ = jax_model
    broken = jax.tree.map(lambda a: a, params["params"])
    del broken["final_block"]["plddt_head"]
    with pytest.raises(KeyError, match="plddt_head"):
        bridge.state_dict_from_flax(broken, port_config(CFG))


def test_slice_with_pair_kernels_matches_jax():
    """At L = 128 kernels C, D, E and F run on both sides (JAX in interpret
    mode, the port through the plain versions), float32, within 1e-4; the
    JAX tree of this length loads strictly, with no new mapping."""
    rng = np.random.default_rng(1)
    msa = rng.integers(0, 21, (1, 2, L_KERNELS)).astype(np.int32)
    inputs = (msa, msa[:, 0], np.arange(L_KERNELS, dtype=np.int32)[None])
    params = random_params(JaxRoseTTAFold(config=CFG), *inputs, seed=1)
    j, t = _outputs(CFG, params, inputs)
    for a, b in zip(t, j):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("length", [384, 385, 1025])
def test_fast_preset_range(length):
    """The fast preset builds at every L: the dense SE(3) layout up to
    L = 384, the bucketed one above, and above 1024 the row-chunked pair
    ResNets (head_chunk 512) as well. (Built on the meta device: structure
    only, no flagship-size memory.)"""
    cfg = tpredict.fast_config(length)
    with torch.device("meta"):
        model = RoseTTAFold(cfg, init=False)
    assert model.config.attn_impl == "pallas"
    assert model.config.se3_impl == ("dense" if length <= 384 else "bucket")
    coord = model.three_track_0.coord_update_with_msa_and_pair
    assert (coord.se3_impl, coord.n_neighbors, coord.k_dynamic) == (
        model.config.se3_impl, 128, 128)  # scanned: top-k at K_max, cut to the block's K
    chunk = 512 if length > 1024 else None
    assert model.config.head_chunk == chunk
    assert model.prediction_head.theta_head.row_chunk == chunk
    assert model.final_block.two_track.pair_update_with_msa.row_chunk == chunk


@pytest.mark.parametrize("field,value,what", [("se3_impl", "scatter", "scatter"),
                                              ("long_chunk", 256, "long_chunk"),
                                              ("use_template", True, "template")])
def test_unported_paths_raise(field, value, what):
    """The scatter SE(3) layout, the long_chunk path and the template input,
    which the port once refused, are ported: the fast preset at L = 512
    builds with each (on the meta device: structure only), and its modules
    carry the option."""
    cfg = dataclasses.replace(tpredict.fast_config(512), **{field: value})
    with torch.device("meta"):
        model = RoseTTAFold(cfg, init=False)
    blk = model.three_track_0
    assert blk.coord_update_with_msa_and_pair.se3_impl == cfg.se3_impl
    assert blk.two_track.pair_update_with_msa.outer_product_mean.chunk_size == cfg.long_chunk
    axial = blk.two_track.pair_update_with_axial_attention.layer_0
    assert axial.row_attn.chunk_rows == axial.col_attn.chunk_rows == cfg.long_chunk
    assert hasattr(model.pair_emb, "ln_template") == cfg.use_template
    assert getattr(cfg, field) == value, what


def test_predict_cli_writes_pdb_npz_json(tmp_path, capsys):
    out, npz = tmp_path / "pred.pdb", tmp_path / "pred.npz"
    tpredict.main(["--a3m", os.path.join(REPO, "examples", "demo_casp.a3m"),
                   "--out", str(out), "--npz", str(npz), "--crop", "24", "--n-seq", "4",
                   "--preset", "fast", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["L"] == 24 and rec["n_seq"] == 4 and np.isfinite(rec["mean_plddt"])
    atoms = [ln for ln in out.read_text().splitlines() if ln.startswith("ATOM")]
    assert len(atoms) == 3 * 24
    logits = np.load(npz)
    assert logits["dist"].shape == (24, 24, 37) and logits["phi"].shape == (24, 24, 19)
