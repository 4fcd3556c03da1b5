"""The port's training path against the JAX package's on the CPU: geometry,
losses, the data pipeline, the optimizer, whole-model gradients (the port's
kernel path through the kernels' plain versions), checkpoints, the eval step
and forward, the train CLI and remat. Inputs are made from numpy seeds."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rosettafold_tpu import tiny_config as jax_tiny_config
from rosettafold_tpu.data import dataset as jdataset
from rosettafold_tpu.models.rosettafold import RoseTTAFold as JaxRoseTTAFold
from rosettafold_tpu.train import geometry as jgeo
from rosettafold_tpu.train import losses as jlosses
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch import train_cli as tcli
from rosettafold_tpu_torch.config import tiny_config
from rosettafold_tpu_torch.data import dataset as tdataset
from rosettafold_tpu_torch.data import pdb as tpdb
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold
from rosettafold_tpu_torch.train import checkpoint as tckpt
from rosettafold_tpu_torch.train import geometry as tgeo
from rosettafold_tpu_torch.train import losses as tlosses
from rosettafold_tpu_torch.train import step as tstep
from rosettafold_tpu_torch.train.loop import fit
from tests.port_utils import one_thread  # noqa: F401 (autouse fixture)
from tests.port_utils import port_config, random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Synthetic (A3M, PDB) pairs from examples/make_demo_pairs.py."""
    out = tmp_path_factory.mktemp("pairs")
    subprocess.run([sys.executable, os.path.join(REPO, "examples", "make_demo_pairs.py"),
                    str(out), "3", "40", "0"], check=True, capture_output=True, cwd=REPO)
    return tcli.find_pairs(str(out))


def _coords(B=2, L=12, seed=0):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, L, 3, 3)) * 3.0).astype(np.float32)
    pred = (xyz + rng.normal(size=xyz.shape) * 0.8).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, -3:] = False
    return xyz, pred, mask


def test_geometry_matches_jax():
    xyz, pred, mask = _coords()
    np.testing.assert_allclose(tgeo.virtual_cb(T(xyz)).numpy(),
                               np.asarray(jgeo.virtual_cb(xyz)), atol=1e-5)
    lt, lj = tgeo.sixd_labels(T(xyz)), jgeo.sixd_labels(jnp.asarray(xyz))
    for k in ("dist", "omega", "theta", "phi", "mask_2d"):
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), err_msg=k)
    for m in (None, mask):
        tm, jm = (None, None) if m is None else (T(m), jnp.asarray(m))
        np.testing.assert_allclose(tgeo.lddt_ca(T(pred), T(xyz), residue_mask=tm).numpy(),
                                   np.asarray(jgeo.lddt_ca(pred, xyz, residue_mask=jm)), atol=1e-5)
        np.testing.assert_allclose(tgeo.drmsd(T(pred), T(xyz), residue_mask=tm).numpy(),
                                   np.asarray(jgeo.drmsd(pred, xyz, residue_mask=jm)), atol=1e-5)


def test_losses_match_jax():
    xyz, pred, mask = _coords(seed=1)
    rng = np.random.default_rng(2)
    B, L = mask.shape
    logits = {k: rng.normal(size=(B, L, L, n)).astype(np.float32)
              for k, n in (("theta", 37), ("phi", 19), ("dist", 37), ("omega", 37))}
    plddt = rng.normal(size=(B, L)).astype(np.float32)
    for m in (None, mask):
        tot_t, met_t = tlosses.rosettafold_loss(
            ({k: T(v) for k, v in logits.items()}, T(pred), T(plddt)), T(xyz),
            residue_mask=None if m is None else T(m))
        tot_j, met_j = jlosses.rosettafold_loss((logits, pred, plddt), xyz, residue_mask=m)
        assert set(met_t) == set(met_j)
        for k in met_j:
            np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    assert tlosses.DEFAULT_WEIGHTS == jlosses.DEFAULT_WEIGHTS


def test_read_pdb_and_batches_match_jax(pairs):
    from rosettafold_tpu.data import pdb as jpdb

    for a3m, pdb in pairs:
        xt, st = tpdb.read_pdb_backbone(pdb)
        xj, sj = jpdb.read_pdb_backbone(pdb)
        np.testing.assert_array_equal(xt, xj)
        assert st == sj
        et, ej = tdataset.load_example(a3m, pdb), jdataset.load_example(a3m, pdb)
        for f in ("msa", "xyz", "aa_idx", "mask"):
            np.testing.assert_array_equal(getattr(et, f), getattr(ej, f))
    for crop, n_seq, sub in ((24, 4, "uniform"), (48, 64, "diversity")):
        bt = tdataset.batches(pairs, batch_size=2, n_seq=n_seq, crop_len=crop, seed=3,
                              subsample=sub)
        bj = jdataset.batches(pairs, batch_size=2, n_seq=n_seq, crop_len=crop, seed=3,
                              subsample=sub)
        for _ in range(3):
            a, b = next(bt), next(bj)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = list(tdataset.prefetch(iter(range(5)), size=2))
    assert got == list(range(5))


@pytest.mark.parametrize("moment_dtype,accum", [("float32", 1), ("bfloat16", 1),
                                                ("float32", 2), ("bfloat16", 2)])
def test_optimizer_matches_optax(moment_dtype, accum):
    """Identical gradients through optax's chain (jitted, as the JAX train
    step runs it) and OptaxAdamW: parameters and moments within 1e-6 after
    every call, with and without the clip, with and without a given norm."""
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    mu_dtype = jnp.bfloat16 if moment_dtype == "bfloat16" else None
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2, weight_decay=1e-4, mu_dtype=mu_dtype))
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt = tstep.OptaxAdamW(tp, lr=1e-2, weight_decay=1e-4, grad_clip=1.0, accum_steps=accum,
                           mu_dtype=torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    for it in range(6):
        scale = 0.05 if it % 2 else 3.0  # below and above the clip norm
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        upd, jstate = update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = T(g.copy())
        # the train step hands over this batch's norm, which the clip reads
        # only without accumulation (else the mean's)
        opt.step(grad_norm=tstep.global_norm([p.grad for p in tp]) if it % 3 else None)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    inner = jstate.inner_opt_state if accum > 1 else jstate
    adam = inner[1][0]
    for p, mu, nu in zip(tp, adam.mu, adam.nu):
        st = opt.state[p]
        assert st["mu"].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(st["mu"].float().numpy(), np.asarray(mu, np.float32),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(st["nu"].numpy(), np.asarray(nu), atol=1e-6, rtol=1e-6)


def _model_batch(L, seed=0):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (1, 4, L)).astype(np.int32)
    xyz = (rng.normal(size=(1, L, 3, 3)) * 3.0).astype(np.float32)
    mask = np.ones((1, L), bool)
    mask[0, -2:] = False
    return {"msa": msa, "seq": msa[:, 0], "aa_idx": np.arange(L, dtype=np.int32)[None],
            "xyz": xyz, "mask": mask}


def _tiny_kernel_cfg(**kw):
    """tiny width, kernel mode, the bf16 trunk and remat, as the card trains."""
    return tiny_config(attn_impl="pallas", remat=True, compute_dtype="bfloat16", **kw)


def test_remat_keeps_dropout_masks():
    """With dropout on, the remat'd model's gradients equal the unremat'd
    one's for the same step seed: the recomputation draws the forward's
    masks."""
    batch = tstep.to_device(_model_batch(12, seed=1), "cpu")
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(_tiny_kernel_cfg(), remat=remat)
        state = tstep.create_train_state(cfg, seed=0, device="cpu")
        state, m = tstep.make_train_step(cfg)(state, batch, 5)
        grads.append([p.grad.clone() for p in state.model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_eval_step_and_forward():
    """eval_step and forward run the model in eval mode without gradients
    (JAX's deterministic apply) and leave its mode as they found it."""
    cfg = _tiny_kernel_cfg()
    batch = tstep.to_device(_model_batch(12, seed=3), "cpu")
    model = tstep.create_train_state(cfg, seed=0, device="cpu").model
    metrics = tstep.make_eval_step(cfg)(model, batch)
    _, xyz, plddt = tstep.make_forward(cfg)(model, batch["msa"], batch["seq"], batch["aa_idx"])
    assert model.training and not xyz.requires_grad
    model.eval()
    with torch.no_grad():
        _, want = tstep._forward_loss(model, batch)
        _, xyz_ref, plddt_ref = model(batch["msa"], batch["seq"], batch["aa_idx"])
    assert set(metrics) == set(want)
    for k in want:
        torch.testing.assert_close(metrics[k], want[k], atol=0, rtol=0, msg=k)
    torch.testing.assert_close(xyz, xyz_ref, atol=0, rtol=0)
    torch.testing.assert_close(plddt, plddt_ref, atol=0, rtol=0)


def test_loss_falls_and_checkpoint_round_trip(tmp_path):
    """Six CPU steps on one batch lower the loss (tests/test_train.py:99-110);
    a sync and an async checkpoint restore the model, the optimizer and the
    step bit for bit."""
    cfg = _tiny_kernel_cfg()
    batch = tstep.to_device(_model_batch(12, seed=2), "cpu")
    state = tstep.create_train_state(cfg, seed=0, learning_rate=3e-4, device="cpu",
                                     moment_dtype="bfloat16")
    step = tstep.make_train_step(cfg)
    losses = []
    for _ in range(6):
        state, m = step(state, batch, 7)
        losses.append(float(m["total"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 6
    for async_ in (False, True):
        path = str(tmp_path / f"ck_{async_}")
        tckpt.save(path, state, async_=async_)
        other = tstep.create_train_state(cfg, seed=1, learning_rate=3e-4, device="cpu",
                                         moment_dtype="bfloat16")
        other = tckpt.restore(path, target=other)
        assert other.step == state.step
        for (n, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
        for p, q in zip(state.model.parameters(), other.model.parameters()):
            for k in ("mu", "nu"):
                a, b = state.optimizer.state[p][k], other.optimizer.state[q][k]
                assert a.dtype == b.dtype
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        assert other.optimizer.count == state.optimizer.count


def test_train_cli_tiny_cpu(pairs, tmp_path, capsys):
    data_dir = os.path.dirname(pairs[0][0])
    ck = tmp_path / "ck"
    tcli.main(["--data-dir", data_dir, "--steps", "2", "--preset", "tiny", "--device", "cpu",
               "--batch-size", "1", "--n-seq", "4", "--crop", "20", "--log-every", "1",
               "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    assert "step 2/2" in out and (ck / "latest" / "state.pt").exists()
    tcli.main(["--data-dir", data_dir, "--steps", "2", "--preset", "tiny", "--device", "cpu",
               "--ckpt-dir", str(ck), "--crop", "20", "--batch-size", "1", "--n-seq", "4"])
    assert "resumed from step 2" in capsys.readouterr().out


@pytest.mark.parametrize("mesh,error", [(dict(n_devices=2), RuntimeError),
                                        (dict(sp=2), NotImplementedError),
                                        (dict(tp=2), ValueError)],
                         ids=["mesh0", "mesh1", "mesh2"])
def test_fit_refuses_mesh(mesh, error):
    """fit never trains on one device where a mesh was asked for: n_devices
    > 1 needs an initialized process group (torchrun), sp > 1 is not ported
    (ROADMAP queue 1, item 6b), tp > 1 needs n_devices. The mesh itself is
    held in tests/test_torch_mesh.py."""
    with pytest.raises(error, match="torchrun|6b|n_devices"):
        fit(tiny_config(), iter([]), 1, device="cpu", **mesh)


def test_fit_refuses_to_train_alone_in_a_world(monkeypatch):
    """A process group of several ranks without n_devices raises (each rank
    would train its own model); the real world is in tests/test_torch_mesh.py."""
    from rosettafold_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="n_devices=2"):
        fit(tiny_config(), iter([]), 1, device="cpu")


def test_dropout_rate_matches_jax():
    """The port's nn.Dropout against JAX's Dropout (models/dropout.py) in the
    positional encoding's training step, p = 0.1 on 131072 elements: their
    RNG streams differ, so the masks are held by statistics. In each package
    the zeroed share lies within 5 sigma of p (sigma the binomial's,
    sqrt(p (1 - p) / n)) and the two shares within 5 sigma of each other;
    a kept value is JAX's x / (1 - p) and PyTorch's x * (1 / (1 - p)) (its
    scale rounded to float32 first) exactly, within one ulp of each other;
    eval mode / deterministic=True is the identity. JAX's recompute-VJP
    Dropout stays unported: the port's masks are PyTorch's, saved for the
    backward (ROADMAP)."""
    from rosettafold_tpu.models.embeddings import SinusoidalPositionalEncoding as JaxPE
    from rosettafold_tpu_torch.models.embeddings import SinusoidalPositionalEncoding as PE

    p, dim, max_len = 0.1, 64, 128
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 32, 64, dim)).astype(np.float32)
    aa = np.arange(64, dtype=np.int32)[None]
    jmod = JaxPE(dim, max_len, p)
    j_eval = np.asarray(jmod.apply({}, x, aa, deterministic=True))
    j_train = np.asarray(jmod.apply({}, x, aa, deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(3)}))
    tmod = PE(dim, max_len, p)
    tmod.eval()
    t_eval = tmod(T(x), T(aa)).numpy()
    tmod.train()
    torch.manual_seed(3)
    t_train = tmod(T(x), T(aa)).numpy()
    np.testing.assert_allclose(t_eval, j_eval, atol=1e-6, rtol=0)
    assert (j_eval != 0).all() and (t_eval != 0).all()
    n = x.size
    sigma = np.sqrt(p * (1 - p) / n)
    shares = {}
    for name, train, ref, kept in (
            ("jax", j_train, j_eval, lambda r: r / np.float32(1 - p)),
            ("port", t_train, t_eval, lambda r: r * np.float32(1 / (1 - p)))):
        zero = train == 0
        shares[name] = zero.mean()
        assert abs(shares[name] - p) <= 5 * sigma, (name, shares[name])
        np.testing.assert_array_equal(train[~zero], kept(ref[~zero]), err_msg=name)
        np.testing.assert_array_max_ulp(train[~zero], ref[~zero] / np.float32(1 - p), maxulp=1)
    assert abs(shares["jax"] - shares["port"]) <= 5 * sigma, shares
    with torch.no_grad():
        tmod.eval()
        np.testing.assert_array_equal(tmod(T(x), T(aa)).numpy(), t_eval)
    np.testing.assert_array_equal(t_eval, (T(x) + tmod.table[:64][None, None]).numpy())


def test_model_gradients_match_jax():
    """The port's kernel path, tiny_config(attn_impl="pallas", p_dropout=0,
    scan_blocks=True) at L = 16 (kernels A and B through their plain
    versions and backwards), against jax.grad of JAX's loss on JAX's plain
    path (attn_impl="xla": the same parameter tree; the JAX package's tests
    hold its kernel path to it, and the backward tests of
    tests/test_torch_kernels.py hold each port backward to JAX's kernels).
    Every parameter's gradient within 1e-4 + 1e-3 of its largest magnitude;
    the bridge maps JAX's gradient tree onto the port's names, as it maps
    the parameters. Weights from seed 1: with seed 0 one SE(3) radial ReLU
    input sits at zero to float32 rounding, so its weight's gradient flips
    with the order of the CPU's sums (the thread count); at seed 1 the worst
    leaf is at 0.02 of its bound with 1, 4 or 8 threads. Last in the file:
    in a parallel run of the suite the PyTorch train steps above ran 10-40x
    slower after this test's JAX compile than when run before it."""
    cfg = jax_tiny_config(attn_impl="xla", p_dropout=0.0, scan_blocks=True)
    batch = _model_batch(16)
    jmodel = JaxRoseTTAFold(config=cfg)
    params = random_params(jmodel, batch["msa"], batch["seq"], batch["aa_idx"], seed=1)

    def jloss(p):
        out = jmodel.apply(p, batch["msa"], batch["seq"], batch["aa_idx"])
        return jlosses.rosettafold_loss(out, batch["xyz"], residue_mask=batch["mask"])[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tcfg = dataclasses.replace(port_config(cfg), attn_impl="pallas")
    model = RoseTTAFold(tcfg, init=False)
    model.load_state_dict(bridge.state_dict_from_flax(params, tcfg), strict=True)
    model.train()
    tl, _ = tstep._forward_loss(model, tstep.to_device(batch, "cpu"))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = bridge.state_dict_from_flax(jax.tree.map(np.asarray, jg), tcfg)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        t = got[name].grad
        assert t is not None, name
        scale = float(g.abs().max())
        np.testing.assert_allclose(t.numpy(), g.numpy(), atol=1e-4 + 1e-3 * scale, rtol=0,
                                   err_msg=name)
