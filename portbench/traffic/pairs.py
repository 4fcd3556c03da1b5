"""Synthetic (A3M, PDB) training pairs (copy of examples/make_demo_pairs.py,
writing the PDB itself): CASP-style A3Ms and backbones whose CA trace is a
smooth 3.8 A/step curve with helix-like local geometry, N and C placed at
standard bond lengths from CA."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .a3m import make as make_a3m

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
_THREE = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS", "Q": "GLN",
    "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE", "L": "LEU", "K": "LYS",
    "M": "MET", "F": "PHE", "P": "PRO", "S": "SER", "T": "THR", "W": "TRP",
    "Y": "TYR", "V": "VAL", "-": "GLY",
}


def make_backbone(L: int, rng: np.random.Generator) -> np.ndarray:
    """(L, 3, 3) N/CA/C coords: CA trace = smooth random curve, 3.8 A steps."""
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    ca = [np.zeros(3)]
    for _ in range(L - 1):
        d = d + 0.55 * rng.normal(size=3)
        d /= np.linalg.norm(d)
        ca.append(ca[-1] + 3.8 * d)
    ca = np.stack(ca)
    xyz = np.zeros((L, 3, 3))
    xyz[:, 1] = ca
    for i in range(L):
        prev_d = ca[i] - ca[i - 1] if i > 0 else ca[i] - ca[i + 1]
        next_d = ca[i + 1] - ca[i] if i < L - 1 else ca[i] - ca[i - 1]
        prev_d = prev_d / (np.linalg.norm(prev_d) + 1e-9)
        next_d = next_d / (np.linalg.norm(next_d) + 1e-9)
        perp = np.cross(prev_d, next_d)
        if np.linalg.norm(perp) < 1e-6:
            perp = np.cross(prev_d, np.array([0.0, 0.0, 1.0]))
        perp = perp / (np.linalg.norm(perp) + 1e-9)
        xyz[i, 0] = ca[i] - 1.46 * (0.8 * prev_d + 0.6 * perp)
        xyz[i, 2] = ca[i] + 1.52 * (0.8 * next_d + 0.6 * perp)
    return xyz


def write_pdb(path: str, xyz: np.ndarray, query: str) -> None:
    """Backbone N/CA/C records of chain A, residue names from `query`."""
    lines, serial = [], 1
    for i, aa in enumerate(query):
        res3 = _THREE.get(aa, "GLY")
        for a, atom in enumerate(("N", "CA", "C")):
            x, y, z = xyz[i, a]
            lines.append(f"ATOM  {serial:5d}  {atom:<3s} {res3} A{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           {atom[0]}")
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def make_pairs(out_dir: str, lengths: Sequence[int], n_rows: int, seed: int
               ) -> List[Tuple[str, str]]:
    """One (A3M, PDB) pair a length, each drawn from (seed, index)."""
    os.makedirs(out_dir, exist_ok=True)
    pairs = []
    for i, L in enumerate(lengths):
        sub = [seed, i]
        rng = np.random.default_rng(sub)
        stem = os.path.join(out_dir, f"target_{i:02d}")
        make_a3m(stem + ".a3m", L=L, n_seq=n_rows,
                 seed=int(np.random.SeedSequence(sub).generate_state(1)[0]))
        with open(stem + ".a3m") as f:
            f.readline()
            query = f.readline().strip()
        write_pdb(stem + ".pdb", make_backbone(len(query), rng), query)
        pairs.append((stem + ".a3m", stem + ".pdb"))
    return pairs
