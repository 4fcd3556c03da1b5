"""PDB backbone I/O: N/CA/C coordinates out (plDDT in the B-factor column),
and backbone coordinates in for training targets."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .vocab import AA_ORDER

_THREE = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS", "Q": "GLN",
    "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE", "L": "LEU", "K": "LYS",
    "M": "MET", "F": "PHE", "P": "PRO", "S": "SER", "T": "THR", "W": "TRP",
    "Y": "TYR", "V": "VAL", "-": "GLY",
}
_ONE = {v: k for k, v in _THREE.items() if k != "-"}
_BB_ATOMS = ("N", "CA", "C")


def write_pdb(
    path: str,
    xyz: np.ndarray,
    seq_tokens: np.ndarray,
    plddt: Optional[np.ndarray] = None,
    chain: str = "A",
) -> None:
    """xyz (L, 3, 3) backbone N/CA/C, seq_tokens (L,) ints, plddt (L,) in [0,1]."""
    xyz = np.asarray(xyz, dtype=np.float64)
    L = xyz.shape[0]
    bfac = 100.0 * np.asarray(plddt) if plddt is not None else np.zeros(L)
    table = AA_ORDER + "-"
    serial = 1
    with open(path, "w") as f:
        for i in range(L):
            res3 = _THREE[table[int(seq_tokens[i])]]
            for a, atom in enumerate(_BB_ATOMS):
                x, y, z = xyz[i, a]
                # PDB columns: serial 7-11, name 13-16, resName 18-20,
                # chain 22, resSeq 23-26, xyz 31-54, occ 55-60, bfac 61-66
                f.write(
                    f"ATOM  {serial:5d}  {atom:<3s} {res3:3s} {chain}{i + 1:4d}"
                    f"    {x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{bfac[i]:6.2f}"
                    f"          {atom[0]:>2s}\n"
                )
                serial += 1
        f.write("TER\nEND\n")


def read_pdb_backbone(path: str, chain: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """N/CA/C coordinates of a PDB file: (xyz (L, 3, 3) float32, sequence).
    Residues missing a backbone atom are dropped."""
    residues, order = {}, []
    with open(path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            atom = line[12:16].strip()
            ch = line[21]
            if atom not in _BB_ATOMS or (chain is not None and ch != chain):
                continue
            key = (ch, line[22:27])  # residue number with insertion code
            if key not in residues:
                residues[key] = {"res3": line[17:20].strip()}
                order.append(key)
            residues[key][atom] = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
    xyz, seq = [], []
    for key in order:
        r = residues[key]
        if all(a in r for a in _BB_ATOMS):
            xyz.append([r[a] for a in _BB_ATOMS])
            seq.append(_ONE.get(r["res3"], "A"))
    if not xyz:
        raise ValueError(f"no complete backbone residues in {path}")
    return np.asarray(xyz, dtype=np.float32), "".join(seq)
