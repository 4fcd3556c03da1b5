"""What decides `correct` for the fold cells: the program's outputs, stage by
stage, for a sample of the lengths the window served, against the plain
reference's, run on the same A3M files with the same weights once the
window has closed.

At random weights the model's stages amplify any rounding until the bf16
trunk's final outputs and a float8 trunk's lie about as far from float32
(PERF.md), so the end-to-end outputs cannot tell a sound program from one
that computes in too low a precision. The check follows the program from its
own state instead: after the window, one more request of each sampled
length goes through the same entry and models with `capture.Capture`'s
hooks, and the reference runs each stage on the program's input to it. The
start is checked by itself: the reference embeds its own featurization of
the A3M. The numbers are relative gaps ||program - reference|| /
||reference||, each the worst over its stages and the checked requests:
`msa` and `pair` (the embeddings and every two-track part), `xyz0` (the
initial coordinates), `state` and `xyz` (every SE(3) coordinate update;
coordinates centred on the reference's centroid), `msa_fb` (every
structure-to-MSA feedback), `plddt`, `head` (the prediction head's
projection, its symmetrised input, and each ResNet's stem and residual
blocks) and `logits` (the four ResNets' output projections). The
configuration file holds a limit for each number that separates a sound
program from the control (`limits`), and a mix file may add one for a
number that separates only at its lengths; PERF.md gives the readings they
were set from. A number that is not finite fails.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import presets
from .capture import HEADS, stage_names
from .reference.data.a3m import load_a3m, msa_features
from .reference.lowp import LowPrecisionProducts
from .reference.models.rosettafold import RoseTTAFold as Reference

NUMBERS = ("msa", "pair", "xyz0", "state", "xyz", "msa_fb", "plddt", "head", "logits")


@contextlib.contextmanager
def ieee_float32():
    """Float32 products in float32: no TF32 in matmuls or cuDNN convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 on b's device; inf where not finite."""
    a, b = a.to(b.device, torch.float64), b.double()
    d = float(torch.linalg.vector_norm(a - b))
    n = float(torch.linalg.vector_norm(b))
    g = d / n if n > 0 else (0.0 if d == 0 else math.inf)
    return g if math.isfinite(g) else math.inf


def rel_xyz(a: torch.Tensor, b: torch.Tensor) -> float:
    centre = b.reshape(-1, 3).double().mean(0)
    return rel(a.to(b.device, torch.float64) - centre, b.double() - centre)


def featurize(a3m_path: str, n_seq: int, subsample: str):
    """(msa, seq, aa_idx) of an A3M file, by the reference's own featurizer."""
    return msa_features(load_a3m(a3m_path), n_seq=n_seq, subsample=subsample)


def reference_model(cfg: dict, weights: Dict[str, torch.Tensor], L: int, device):
    with torch.device(device):
        model = Reference(presets.reference_config(cfg, L), init=False)
    model.load_state_dict(weights, strict=True, assign=True)
    return model.to(device).eval()


def _mode(precision: Optional[str]):
    return LowPrecisionProducts(precision) if precision else contextlib.nullcontext()


def stage_gaps(cfg: dict, weights, a3m_path: str, n_seq: int, subsample: str, device,
               captured: Dict[str, object]) -> Dict[str, float]:
    """The numbers of one request: each stage of the float32 reference run on
    the captured input to it, against the captured output."""
    msa, seq, aa_idx = (torch.as_tensor(a, device=device)
                        for a in featurize(a3m_path, n_seq, subsample))
    ref = reference_model(cfg, weights, msa.shape[-1], device)
    f32 = lambda t: t.to(device, torch.float32)  # noqa: E731
    gaps = {k: 0.0 for k in NUMBERS}

    def note(key, got, want):
        g = (rel_xyz if key.startswith("xyz") else rel)(got, want)
        gaps[key] = max(gaps[key], g)

    with torch.no_grad(), ieee_float32():
        # the start, from the raw input
        note("msa", captured["embed"][0], ref.msa_emb(msa, aa_idx))
        note("pair", captured["embed"][1], ref.pair_emb(seq, aa_idx, None))
        onehot = F.one_hot(seq.long(), ref.config.d_input).float()
        s = {"msa": f32(captured["embed"][0]), "pair": f32(captured["embed"][1])}
        for name in stage_names(ref.config):
            mod, got, part = ref.get_submodule(name), captured[name], name.rsplit(".", 1)[-1]
            if part.startswith("two_track"):
                want, keys = mod(s["msa"], s["pair"]), ("msa", "pair")
            elif part == "initial_coords":
                want, got, keys = (mod(s["msa"], s["pair"], onehot, aa_idx),), (got,), ("xyz0",)
            elif part == "coord_update_with_msa_and_pair":
                want = mod(s["xyz"], s["msa"], s["pair"], aa_idx, onehot)
                keys = ("state", "xyz")
            elif part == "msa_update_with_pair_and_coord":
                want, got, keys = (mod(s["xyz"], s["state"], s["msa"]),), (got,), ("msa_fb",)
            else:  # plddt_head
                want, got, keys = (mod(s["state"]),), (got,), ("plddt",)
            for k, g, w in zip(keys, got, want):
                note(k, g, w)
                # the next stage starts from the program's state
                s["xyz" if k == "xyz0" else "msa" if k == "msa_fb" else k] = f32(g)
            del want
        head_gaps(ref.prediction_head, s["pair"], captured, note)
    del ref
    return gaps


def head_gaps(head, pair, captured: Dict[str, object], note):
    """The prediction head, piece by piece from the program's state: its
    projection from the program's last pair, each ResNet's input (the
    projection, symmetrised for dist and omega), stem and residual blocks
    (`head`), and each output projection (`logits`)."""
    f32 = lambda t: t.to(pair.device, torch.float32)  # noqa: E731
    x = captured["head.proj"]
    note("head", x, head.dropout(head.proj(head.proj_ln(pair))))
    x = f32(x)
    for h in HEADS:
        res = getattr(head, f"{h}_head")
        inp = captured[f"{h}.in"][0]
        note("head", inp, x if h in ("theta", "phi") else 0.5 * (x + x.transpose(1, 2)))
        stem = captured[f"{h}.stem"][0]
        note("head", stem, res.stem(f32(inp)))
        prev = stem
        for i in range(res.n):
            out = captured[f"{h}.block_{i}"]
            note("head", out, getattr(res, f"block_{i}")(f32(prev)))
            prev = out
        note("logits", captured[f"{h}.logits"], res.proj_out(f32(prev)))


def control_capture(cfg: dict, weights, a3m_path: str, n_seq: int, subsample: str, device,
                    precision: str):
    """The control put in the program's place: the reference's own forward
    with its products in `precision`, its stages captured as the program's."""
    from .capture import Capture

    msa, seq, aa_idx = (torch.as_tensor(a, device=device)
                        for a in featurize(a3m_path, n_seq, subsample))
    L = msa.shape[-1]
    ref = reference_model(cfg, weights, L, device)
    # on the host: the float32 control's stages at L=1100 outgrow the card
    cap = Capture(store="cpu")
    handles = cap.hooks(ref, L)
    try:
        with torch.no_grad(), ieee_float32(), _mode(precision):
            ref(msa, seq, aa_idx)
    finally:
        for h in handles:
            h.remove()
    return cap.result(L)


def limits(cfg: dict, mix: dict) -> Dict[str, float]:
    """A cell's limits: its configuration's, and those its mix adds for a
    number that separates only at the mix's lengths."""
    return {**cfg["limits"], **mix.get("limits", {})}


def judge(worst: Dict[str, float], limits: Dict[str, float]):
    """(correct, [[name, number, limit], ...]) over the numbers with a limit;
    a number the run did not read counts as infinite."""
    rows = [[k, worst.get(k, math.inf), lim] for k, lim in limits.items()]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    return ok, rows


def worst_of(readings) -> Dict[str, float]:
    """Each number's worst over the checked items' readings ({name: number})."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out
