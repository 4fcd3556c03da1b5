"""Backbone geometry: virtual CB, binned 6D labels, lDDT and dRMSD (port of
rosettafold_tpu/train/geometry.py).

  dist  = |CB_i - CB_j|                      36 bins of 0.5 A over [2, 20) + no-contact
  omega = dihedral(CA_i, CB_i, CB_j, CA_j)   36 bins of 10 deg + no-contact
  theta = dihedral(N_i, CA_i, CB_i, CB_j)    36 bins of 10 deg + no-contact
  phi   = angle(CA_i, CB_i, CB_j)            18 bins of 10 deg + no-contact
"""

from __future__ import annotations

import math
from typing import Dict

import torch

N_IDX, CA_IDX, C_IDX = 0, 1, 2
DIST_BINS, OMEGA_BINS, THETA_BINS, PHI_BINS = 37, 37, 37, 19
NO_CONTACT_CUTOFF = 20.0


def virtual_cb(xyz: torch.Tensor) -> torch.Tensor:
    """Ideal C-beta from backbone N/CA/C (..., 3, 3) -> (..., 3)."""
    n, ca, c = xyz[..., N_IDX, :], xyz[..., CA_IDX, :], xyz[..., C_IDX, :]
    b, cc = ca - n, c - ca
    a = torch.cross(b, cc, dim=-1)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca


def _dihedral(p0, p1, p2, p3, eps=1e-8):
    """Dihedral angle in (-pi, pi] of batched points (..., 3)."""
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    b1n = b1 / (torch.linalg.norm(b1, dim=-1, keepdim=True) + eps)
    v = b0 - (b0 * b1n).sum(-1, keepdim=True) * b1n
    w = b2 - (b2 * b1n).sum(-1, keepdim=True) * b1n
    x = (v * w).sum(-1)
    y = (torch.cross(b1n, v, dim=-1) * w).sum(-1)
    return torch.atan2(y, x + eps)


def _planar_angle(p0, p1, p2, eps=1e-8):
    """Angle at p1 in [0, pi] of batched points (..., 3)."""
    v1, v2 = p0 - p1, p2 - p1
    v1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + eps)
    v2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + eps)
    return torch.arccos(torch.clamp((v1 * v2).sum(-1), -1.0, 1.0))


def _pdist(x):
    d = x[:, :, None, :] - x[:, None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-8)


def sixd_labels(xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Binned 6D labels from true backbone coordinates (B, L, 3, 3): int64
    dist/omega/theta in [0, 36] and phi in [0, 18], the last bin of each the
    no-contact bin (CB distance >= 20 A, and the diagonal); mask_2d the
    off-diagonal pairs."""
    ca, n, cb = xyz[..., CA_IDX, :], xyz[..., N_IDX, :], virtual_cb(xyz)
    B, L = ca.shape[:2]
    cb_i, cb_j = cb[:, :, None, :], cb[:, None, :, :]
    dist = torch.sqrt(((cb_i - cb_j) ** 2).sum(-1) + 1e-8)
    eye = torch.eye(L, dtype=torch.bool, device=xyz.device)[None]
    no_contact = (dist >= NO_CONTACT_CUTOFF) | eye

    def clip_bin(x, hi):  # truncation toward zero, as astype(int32)
        return torch.clamp(x.to(torch.int32), 0, hi).long()

    dist_lab = torch.where(no_contact, DIST_BINS - 1, clip_bin((dist - 2.0) / 0.5, 35))
    ca_i, ca_j, n_i = ca[:, :, None, :], ca[:, None, :, :], n[:, :, None, :]
    omega = _dihedral(ca_i, cb_i, cb_j, ca_j)
    theta = _dihedral(n_i, ca_i, cb_i, cb_j)
    phi = _planar_angle(ca_i, cb_i, cb_j)

    def angle_bin(x, n_bins):  # x in (-pi, pi] over the full circle
        return clip_bin((x * (180.0 / math.pi) + 180.0) / 10.0, n_bins - 1)

    return {
        "dist": dist_lab,
        "omega": torch.where(no_contact, OMEGA_BINS - 1, angle_bin(omega, 36)),
        "theta": torch.where(no_contact, THETA_BINS - 1, angle_bin(theta, 36)),
        "phi": torch.where(no_contact, PHI_BINS - 1,
                           clip_bin(phi * (180.0 / math.pi) / 10.0, 17)),
        "mask_2d": (~eye).expand(B, L, L),
    }


def lddt_ca(pred_xyz, true_xyz, cutoff: float = 15.0, residue_mask=None):
    """Per-residue CA lDDT in [0, 1] (B, L): the share of preserved distances
    at 0.5/1/2/4 A among true neighbours within `cutoff`; padded residues
    (residue_mask False) are left out of the neighbour sets."""
    dt = _pdist(true_xyz[..., CA_IDX, :])
    dp = _pdist(pred_xyz[..., CA_IDX, :])
    L = dt.shape[1]
    incl = (dt < cutoff) & ~torch.eye(L, dtype=torch.bool, device=dt.device)[None]
    if residue_mask is not None:
        incl = incl & residue_mask[:, None, :].bool()
    diff = (dt - dp).abs()
    score = sum((diff < t).float() for t in (0.5, 1.0, 2.0, 4.0)) / 4.0
    denom = torch.clamp(incl.sum(-1), min=1)
    return (score * incl).sum(-1) / denom


def drmsd(pred_xyz, true_xyz, residue_mask=None):
    """Superposition-free distance-matrix RMSD over CA atoms, one per batch
    entry; only valid x valid off-diagonal pairs count."""
    dt = _pdist(true_xyz[..., CA_IDX, :])
    dp = _pdist(pred_xyz[..., CA_IDX, :])
    L = dt.shape[1]
    off = ~torch.eye(L, dtype=torch.bool, device=dt.device)[None]
    if residue_mask is not None:
        m = residue_mask.bool()
        off = off & m[:, :, None] & m[:, None, :]
    sq = torch.where(off, (dt - dp) ** 2, torch.zeros_like(dt))
    return torch.sqrt(sq.sum((1, 2)) / torch.clamp(off.sum((1, 2)), min=1))
