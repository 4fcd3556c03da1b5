"""MSA row-subsampling strategies for `msa_features(subsample=...)`."""

from __future__ import annotations

from typing import List

import numpy as np

STRATEGIES = ("uniform", "weighted", "diversity")


def subsample_rows(
    msa: np.ndarray,
    n_seq: int,
    rng: np.random.Generator,
    strategy: str,
    pool: int = 1024,
) -> np.ndarray:
    """Pick n_seq-1 homolog row indices; the query (row 0) is always kept.

    uniform   — random rows.
    weighted  — rows drawn with weight 1/|{j : identity(i, j) >= 0.8}|.
    diversity — greedy max-min Hamming distance from the selection so far.

    The O(N^2 L) strategies first cap the candidates at `pool` random rows.
    Returns sorted indices into `msa`, starting with 0."""
    N = msa.shape[0]
    take = n_seq - 1
    cand = np.arange(1, N)
    if strategy != "uniform" and cand.size > pool:
        cand = np.sort(rng.permutation(cand)[:pool])

    if strategy == "uniform":
        keep = rng.permutation(cand.size)[:take]
        return np.sort(np.concatenate([[0], cand[keep]]))

    sub = msa[cand]  # (C, L)
    if strategy == "weighted":
        ident = (sub[:, None, :] == sub[None, :, :]).mean(-1)  # (C, C)
        neighbors = (ident >= 0.8).sum(-1)  # >= 1 (self)
        w = 1.0 / neighbors
        p = w / w.sum()
        keep = rng.choice(cand.size, size=min(take, cand.size),
                          replace=False, p=p)
        return np.sort(np.concatenate([[0], cand[keep]]))

    if strategy == "diversity":
        dist_to_sel = (sub != msa[0][None, :]).mean(-1)  # (C,)
        chosen: List[int] = []
        for _ in range(min(take, cand.size)):
            nxt = int(np.argmax(dist_to_sel))
            chosen.append(nxt)
            d_new = (sub != sub[nxt][None, :]).mean(-1)
            dist_to_sel = np.minimum(dist_to_sel, d_new)
            dist_to_sel[nxt] = -1.0  # never re-pick
        return np.sort(np.concatenate([[0], cand[chosen]]))

    raise ValueError(
        f"unknown subsample strategy {strategy!r} "
        f"(expected one of {STRATEGIES})")
