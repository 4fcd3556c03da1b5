"""The port's dp and tp training (rosettafold_tpu_torch/parallel) on the CPU,
over gloo, against the JAX package.

Each world is `python -m rosettafold_tpu_torch.parallel.dryrun` launched as
one subprocess a rank, joined through a FileStore under the test's tmp dir
(no ports to clash between parallel test workers); each child pins one
PyTorch thread and imports no JAX. The three worlds (dp=2 x tp=2 in four
processes, dp=2 and tp=2 in two each) start together when the module's
fixture is first used and run every check of their world in that launch;
meanwhile this process computes the references: the port's single-process
step, then jax.value_and_grad of JAX's loss on the same global batch (whose
two examples mask different residues) with the same seed-1 weights, carried
across by the bridge. Kernels A and C run split over tp in the tp=2 world
(their plain versions) and are held to JAX's tp_shard_map of the plain
functions on the 8 virtual devices of conftest.py."""

import dataclasses
import json
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
from rosettafold_tpu.ops.pallas.fused_performer import _ln as jax_ln
from rosettafold_tpu.ops.pallas.fused_performer import xla_reference
from rosettafold_tpu.parallel import mesh as jmesh
from rosettafold_tpu.train import losses as jlosses
from rosettafold_tpu_torch import bridge
from rosettafold_tpu_torch.data import dataset as tdataset
from rosettafold_tpu_torch.data.pdb import write_pdb
from rosettafold_tpu_torch.data.vocab import AA_ORDER
from rosettafold_tpu_torch.models.attention import PerformerSelfAttention
from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold
from rosettafold_tpu_torch.parallel import dryrun
from rosettafold_tpu_torch.parallel import mesh as tmesh
from rosettafold_tpu_torch.train import checkpoint as tckpt
from rosettafold_tpu_torch.train import step as tstep
from tests.port_utils import one_thread  # noqa: F401 (autouse fixture)
from tests.port_utils import port_config, random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the configuration every world trains: tiny width, the final block alone
# (its two-track block and SE(3) update) after the initial coordinates, two
# encoder layers (the first tied layer runs kernel A, the last returns its
# map), dropout off, scanned seeds; JAX compiles its gradient in ~35 s
OVERRIDES = {"p_dropout": 0.0, "scan_blocks": True, "n_two_track_blocks": 0,
             "n_three_track_blocks": 1, "n_encoder_layers": 2}
# the port also remats its blocks, as the card trains: each block's forward
# collectives run again, in the same order on every rank, in its backward
PORT = {**OVERRIDES, "remat": True}
FUSED_MIN_L = 16  # kernel C's crossover at the batch's L: its row path splits over tp
WORLDS = {"dp2tp2": (4, 2), "dp2": (2, 1), "tp2": (2, 2)}  # name: (processes, tp)


def _bound(g):
    """test_model_gradients_match_jax's tolerance of a leaf's gradient."""
    return 1e-4 + 1e-3 * float(np.abs(g).max())


def _launch(name, n, tp, tmp):
    out, store = tmp / f"{name}.pt", tmp / f"{name}.store"
    args = [sys.executable, "-m", "rosettafold_tpu_torch.parallel.dryrun", "--tp", str(tp),
            "--params", str(tmp / "params.pt"), "--batch", str(tmp / "batch.npz"),
            "--config", json.dumps(PORT), "--fused-min-l", str(FUSED_MIN_L),
            "--out", str(out)]
    if name == "tp2":
        args += ["--ckpt-dir", str(tmp / "ck")]
    env = dict(os.environ, WORLD_SIZE=str(n), DRYRUN_STORE=str(store), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return out, [subprocess.Popen(args, env=dict(env, RANK=str(r)), cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(n)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg = jax_tiny_config(attn_impl="xla", **OVERRIDES)
    tcfg = dataclasses.replace(port_config(jcfg), attn_impl="pallas", remat=True)
    batch = dryrun.tiny_batch(2)
    jmodel = JaxRoseTTAFold(config=jcfg)
    params = random_params(jmodel, batch["msa"], batch["seq"], batch["aa_idx"], seed=1)
    sd = bridge.state_dict_from_flax(params, tcfg)
    torch.save(sd, tmp / "params.pt")
    np.savez(tmp / "batch.npz", **batch)
    launched = {name: _launch(name, n, tp, tmp) for name, (n, tp) in WORLDS.items()}

    # the port's single-process step on the same weights and batch, on one intra-op
    # thread as each rank (one_thread here, OMP_NUM_THREADS in the ranks)
    state = tstep.create_train_state(tcfg, 0, device="cpu")
    state.model.load_state_dict(sd)
    for mod in state.model.modules():
        if isinstance(mod, PerformerSelfAttention):
            mod.fused_favor_min_l = FUSED_MIN_L
    grads = {}  # as the optimizer receives them: it clips them in place
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in state.model.named_parameters()
         if p.grad is not None}))
    state, metrics = tstep.make_train_step(tcfg)(state, tstep.to_device(batch, "cpu"), 0)
    port = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}

    def jloss(p):
        out = jmodel.apply(p, batch["msa"], batch["seq"], batch["aa_idx"])
        return jlosses.rosettafold_loss(out, batch["xyz"], residue_mask=batch["mask"])[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    ref = {"loss": float(jl), "grad_norm": float(optax.global_norm(jg)),
           "grads": bridge.state_dict_from_flax(jax.tree.map(np.asarray, jg), tcfg)}

    results = {}
    for name, (out, procs) in launched.items():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0].decode(errors="replace"))
        codes = [p.returncode for p in procs]
        assert codes == [0] * len(procs), f"world {name} exited {codes}:\n{logs[0][-4000:]}"
        results[name] = torch.load(out, weights_only=False)
    return {"worlds": results, "port": port, "jax": ref, "cfg": tcfg, "tmp": tmp,
            "whole": {k: tuple(v.shape) for k, v in sd.items()}}


def _assert_grads(got, want, what):
    assert set(got) == set(want), what
    for name, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].numpy(), g, atol=_bound(g), rtol=0,
                                   err_msg=f"{what}: {name}")


def test_dp2_tp2_step_matches_jax(run):
    """dp=2 x tp=2: the global batch's loss, gradient norm and gathered
    gradients equal jax.value_and_grad of JAX's loss over the whole batch,
    the two dp halves masked differently."""
    r, ref = run["worlds"]["dp2tp2"], run["jax"]
    assert r["mesh"] == (2, 1, 2) and r["rows"] == 1
    np.testing.assert_allclose(r["metrics"]["total"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(r["metrics"]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    _assert_grads(r["grads"], ref["grads"], "dp2 x tp2 vs JAX")


@pytest.mark.parametrize("world", ["dp2", "tp2"])
def test_dp_or_tp_alone_matches_single_process(run, world):
    """dp=2 alone (a batch row a rank) and tp=2 alone (1/2 of every sharded
    leaf a rank) give the port's single-process loss and gradients."""
    r, port = run["worlds"][world], run["port"]
    dp, _, tp = r["mesh"]
    assert r["rows"] == 2 // dp
    assert bool(r["shards"]) == (tp > 1)
    for name, shape in r["shards"].items():
        whole = run["whole"][name]
        dim = tmesh.tp_rule(name, whole, tp)
        assert dim is not None and shape[dim] * tp == whole[dim], name
    for k in ("total", "grad_norm", "drmsd", "plddt_mse"):
        np.testing.assert_allclose(r["metrics"][k], port["metrics"][k], rtol=1e-5, err_msg=k)
    _assert_grads(r["grads"], port["grads"], f"{world} vs one process")


def _jax_tp_layout(tree):
    """{port state_dict key: torch dim} of the leaves JAX's param_shardings
    puts on 'tp', mapped through the bridge's names: flax's last axis is
    torch's dim 0 (Dense (in, out) -> (out, in), HWIO -> OIHW), its second
    to last dim 1."""
    sh = jmesh.param_shardings(tree, jmesh.make_mesh(8, sp=2, tp=2))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        spec = tuple(s.spec)
        if "tp" not in spec:
            continue
        keys = tuple(p.key for p in path)
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        kind = "weight" if keys[-1] in ("kernel", "scale", "embedding") else keys[-1]
        out[".".join(keys[:-1] + (kind,))] = 0 if spec.index("tp") == np.ndim(leaf) - 1 else 1
    return out


def test_tp_layout_matches_jax_param_shardings(run):
    """At tp=2 the leaves the port's rules shard, and their dims, are JAX's
    param_shardings(tree, make_mesh(8, sp=2, tp=2)) under the bridge's name
    map, for the tiny model and for tests/test_train.py:206's synthetic tree
    (a leaf whose axis does not divide tp stays replicated)."""
    jcfg = jax_tiny_config()  # every module kind of the model
    batch = dryrun.tiny_batch(1)
    params = random_params(JaxRoseTTAFold(config=jcfg), batch["msa"], batch["seq"],
                           batch["aa_idx"])
    want = _jax_tp_layout(params["params"])
    with torch.device("meta"):
        model = RoseTTAFold(port_config(jcfg), init=False)
    got = {n: d for n, p in model.named_parameters()
           if (d := tmesh.tp_rule(n, p.shape, 2)) is not None}
    assert got == want
    assert len(got) > 20
    tree = {"attn": {"to_q": {"kernel": jnp.zeros((24, 16)), "bias": jnp.zeros((16,))},
                     "to_out": {"kernel": jnp.zeros((16, 24)), "bias": jnp.zeros((24,))}},
            "ff": {"fc1": {"kernel": jnp.zeros((24, 96))}, "fc2": {"kernel": jnp.zeros((96, 24))}},
            "odd": {"to_v": {"kernel": jnp.zeros((24, 7))}},
            "ln": {"scale": jnp.zeros((24,))}}
    ports = {".".join(k[:-1] + ("weight" if k[-1] in ("kernel", "scale") else k[-1],)):
             tuple(np.shape(v.T if k[-1] == "kernel" else v))
             for k, v in ((tuple(p.key for p in path), leaf) for path, leaf in
                          jax.tree_util.tree_flatten_with_path(tree)[0])}
    got = {n: d for n, s in ports.items() if (d := tmesh.tp_rule(n, s, 2)) is not None}
    assert got == _jax_tp_layout(tree)
    assert "odd.to_v.weight" not in got and got["attn.to_out.weight"] == 1


def _jax_split(name, t):
    """JAX's tp_shard_map of the plain function of kernel A or C (LN +
    residual) on dryrun.split_inputs(): the output and the gradients of
    sum(out^2), on a (4 dp, 1 sp, 2 tp) mesh of the virtual devices."""
    if name == "A":
        def fn(q, k, v):
            return jax.nn.softmax(q @ jnp.swapaxes(k, -1, -2), axis=-1) @ v
        args, shard = [t[n] for n in "qkv"], None
    else:
        scale, eps, heads, dim_head = dryrun.SPLIT_C_STATICS

        def fn(x, g, b, *w):
            y = jax_ln(x, g, b, dryrun.SPLIT_C_LN_EPS)
            return x + xla_reference(y, *w, t["projection"], scale, eps, heads, dim_head)
        args = [t[n] for n in ("x", "gamma", "beta", "wq", "wk", "wv", "wo", "bo")]
        shard = (0,)

    def loss(*a):
        return jnp.sum(jmesh.tp_shard_map(fn, *a, shard=shard) ** 2)

    with jax.set_mesh(jmesh.make_mesh(8, sp=1, tp=2)):
        out = jax.jit(lambda *a: jmesh.tp_shard_map(fn, *a, shard=shard))(*args)
        grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kernel", ["A", "C"])
def test_split_kernels_match_jax_tp_shard_map(run, kernel):
    """Kernels A and C (their plain versions) split over the tp=2 world's
    ranks by the port's tp_shard_map: forward and gradients equal JAX's
    tp_shard_map runs (the world also held them to its unsplit call)."""
    got = run["worlds"]["tp2"]["split"][kernel]
    want = _jax_split(kernel, {k: jnp.asarray(v) for k, v in dryrun.split_inputs().items()})
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=2e-5, rtol=2e-5)
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(a.numpy(), b, atol=_bound(b), rtol=0, err_msg=f"grad {i}")


def test_tp2_checkpoint_restores_at_tp1_and_serves(run):
    """The tp=2 world's checkpoint holds the whole state: it restores into a
    one-device TrainState (whole moments, step 1), its parameters are the
    single-process step's, and its model loads into predict's RoseTTAFold
    strictly. Adam's first step moves a weight by lr * g / (|g| + eps): lr
    (1e-3) wherever |g| >> eps, so the two runs' rounding shows only where
    |g| is near eps = 1e-8: all but a 1e-2 share of the weights within 1e-6,
    none further apart than two steps."""
    path = str(run["tmp"] / "ck")
    cfg = run["cfg"]
    state = tstep.create_train_state(cfg, 5, device="cpu")
    state = tckpt.restore(path, target=state)
    assert state.step == 1
    ref = run["port"]["params"]
    diffs = []
    for n, p in state.model.named_parameters():
        assert p.shape == ref[n].shape, n
        st = state.optimizer.state[p]
        assert st["mu"].shape == p.shape and st["nu"].shape == p.shape, n
        diffs.append((p.detach() - ref[n]).abs().flatten())
    d = torch.cat(diffs)
    assert float((d > 1e-6).float().mean()) <= 1e-2 and float(d.max()) <= 2e-3
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    serve = RoseTTAFold(cfg, init=False)
    serve.load_state_dict(payload["model"], strict=True)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fit_without_n_devices_refuses_in_a_world(run, world):
    """In a process group of several ranks, fit without n_devices raises
    instead of letting each rank train alone (train_cli under torchrun with
    --n-devices left out)."""
    assert run["worlds"][world]["alone_refused"] is True


def test_dropout_seeds_fold_the_dp_coordinate(run):
    """In the dp=2 x tp=2 world: the two dp rows draw different dropout
    streams, the ranks of a tp group the same (the replicated activations'
    masks agree), and the tp-local masks are distinct blocks of one mask.
    The world also ran a step with dropout on after which every replicated
    parameter was bit-equal across its tp group."""
    rng = run["worlds"]["dp2tp2"]["rng"]  # (rank, 16 shared draws + 8 tp-local)
    shared, local = rng[:, :16], rng[:, 16:]
    assert torch.equal(shared[0], shared[1]) and torch.equal(shared[2], shared[3])
    assert not torch.equal(shared[0], shared[2])
    assert not torch.equal(local[0], local[1]) and not torch.equal(local[2], local[3])
    assert set(local.unique().tolist()) <= {0.0, 2.0}


@pytest.fixture
def sample_pairs(tmp_path):
    """tests/test_dataset_loop.py's three synthetic pairs."""
    rng = np.random.default_rng(0)
    pairs = []
    for t in range(3):
        L = 20 + 4 * t
        seq = "".join(AA_ORDER[i] for i in rng.integers(0, 20, L))
        lines = [">query", seq]
        for n in range(5):
            s = list(seq)
            for i in rng.integers(0, L, 4):
                s[i] = "-"
            lines += [f">h{n}", "".join(s)]
        a3m = tmp_path / f"t{t}.a3m"
        a3m.write_text("\n".join(lines))
        pdbf = tmp_path / f"t{t}.pdb"
        write_pdb(str(pdbf), rng.normal(size=(L, 3, 3)).astype(np.float32) * 4,
                  rng.integers(0, 20, L))
        pairs.append((str(a3m), str(pdbf)))
    return pairs


def test_batches_multihost_match_jax(sample_pairs):
    """batches(process_index=i, process_count=2) is JAX's, bit for bit, for
    both hosts; process 0 of one is the one-host stream."""
    kw = dict(batch_size=1, n_seq=4, crop_len=16, epochs=2, seed=7)
    for i in range(2):
        got = list(tdataset.batches(sample_pairs, process_index=i, process_count=2, **kw))
        want = list(jdataset.batches(sample_pairs, process_index=i, process_count=2, **kw))
        assert len(got) == len(want) == (4 if i == 0 else 2)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    one = list(tdataset.batches(sample_pairs, **kw))
    for a, b in zip(one, tdataset.batches(sample_pairs, process_index=0, process_count=1,
                                          **kw)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(one, jdataset.batches(sample_pairs, **kw)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="process_index"):
        next(tdataset.batches(sample_pairs, process_index=2, process_count=2))
