"""Training losses: 6D-geometry cross-entropy, dRMSD and plDDT terms (port of
rosettafold_tpu/train/losses.py).

Each masked mean's denominator is summed over the dp ranks of the current
mesh (parallel/mesh.py; the identity on one device), and a plain mean over
examples divides by dp as well (every dp rank holds as many), so a rank's
terms are its share of the global batch's loss: their sum over dp is JAX's
loss over the whole batch, and so are the gradients' sums, also where the
residue masks differ between ranks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..parallel.mesh import dp_size, dp_sum
from . import geometry

DEFAULT_WEIGHTS = {"dist": 1.0, "omega": 0.5, "theta": 0.5, "phi": 0.5, "xyz": 1.0,
                   "plddt": 0.1}


def binned_cross_entropy(logits, labels, mask):
    """Masked mean CE: logits (B, L, L, bins), labels int (B, L, L), mask bool."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(dp_sum(mask.sum()), min=1)
    return -torch.where(mask, ll, torch.zeros_like(ll)).sum() / denom


def plddt_loss(plddt_logits, pred_xyz, true_xyz, residue_mask=None):
    """MSE between sigmoid(plDDT head) and the true per-residue CA lDDT (no
    gradient through the target); padded residues left out of the mean."""
    with torch.no_grad():
        target = geometry.lddt_ca(pred_xyz, true_xyz, residue_mask=residue_mask)
    err = (torch.sigmoid(plddt_logits) - target) ** 2
    if residue_mask is None:
        return err.mean() / dp_size()
    m = residue_mask.to(err.dtype)
    return (err * m).sum() / torch.clamp(dp_sum(m.sum()), min=1)


def rosettafold_loss(outputs, true_xyz, residue_mask=None,
                     weights: Dict[str, float] = None) -> Tuple[torch.Tensor, Dict]:
    """(total, metrics) from the model's (logits, xyz, plddt) and the true
    backbone (B, L, 3, 3); labels come from true_xyz. residue_mask (B, L)
    marks valid residues: padded ones leave every term."""
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    logits, pred_xyz, plddt = outputs
    labels = geometry.sixd_labels(true_xyz)
    mask = labels["mask_2d"]
    if residue_mask is not None:
        m = residue_mask.bool()
        mask = mask & m[:, :, None] & m[:, None, :]
    metrics = {}
    total = 0.0
    for head in ("dist", "omega", "theta", "phi"):
        ce = binned_cross_entropy(logits[head], labels[head], mask)
        metrics[f"ce_{head}"] = ce
        total = total + w[head] * ce
    drmsd = geometry.drmsd(pred_xyz, true_xyz, residue_mask=residue_mask)
    xyz_term = drmsd.mean() / dp_size()
    metrics["drmsd"] = xyz_term
    total = total + w["xyz"] * xyz_term
    pl = plddt_loss(plddt, pred_xyz, true_xyz, residue_mask=residue_mask)
    metrics["plddt_mse"] = pl
    total = total + w["plddt"] * pl
    metrics["total"] = total
    return total, metrics
