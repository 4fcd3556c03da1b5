"""A3M / FASTA MSA loading (pure Python) and model-input features."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .vocab import tokenize


def load_a3m(path: str, max_seqs: int = 10000) -> np.ndarray:
    """Parse an A3M/FASTA file -> (n_seqs, L) int8 token matrix (query row 0).
    Lower-case insertions and '.' are dropped; rows must be equally long."""
    seqs = []
    cur: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                if len(seqs) >= max_seqs:
                    break
            elif line:
                cur.append("".join(c for c in line if not (c.islower() or c == ".")))
    if cur and len(seqs) < max_seqs:
        seqs.append("".join(cur))
    if not seqs:
        raise ValueError(f"no sequences in {path}")
    L = len(seqs[0])
    if any(len(s) != L for s in seqs):
        raise ValueError(f"ragged alignment in {path}")
    return np.stack([tokenize(s) for s in seqs]).astype(np.int8)


def msa_features(
    tokens: np.ndarray,
    n_seq: int = 64,
    crop_len: Optional[int] = None,
    subsample: str = "first",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Token matrix -> model inputs (msa (1, N, L), seq (1, L), aa_idx (1, L)).

    Keeps the query plus n_seq-1 deduplicated alignment rows, chosen in
    alignment order ("first") or by a `sampling` strategy, optionally cropped
    to crop_len residues. `seed` matters only for the stochastic strategies."""
    _, uniq_idx = np.unique(
        tokens.view([("", tokens.dtype)] * tokens.shape[1]), return_index=True
    )
    keep = np.sort(uniq_idx)
    if keep[0] != 0:
        keep = np.concatenate([[0], keep[keep != 0]])
    tokens = tokens[keep]
    if subsample == "first" or tokens.shape[0] <= n_seq:
        tokens = tokens[:n_seq]
    else:
        from .sampling import subsample_rows

        tokens = tokens[subsample_rows(
            tokens, n_seq, np.random.default_rng(seed), subsample)]

    if crop_len is not None:
        tokens = tokens[:, :crop_len]
    msa = tokens[None].astype(np.int32)
    seq = msa[:, 0]
    aa_idx = np.arange(msa.shape[-1], dtype=np.int32)[None]
    return msa, seq, aa_idx
