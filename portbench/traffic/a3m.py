"""A CASP-style synthetic A3M (copy of examples/make_demo_a3m.py): natural
amino-acid background frequencies, a phylogeny-like mutation ladder (closer
sequences share more identity), indel runs and a3m lowercase insertions."""

from __future__ import annotations

import numpy as np

AA = "ARNDCQEGHILKMFPSTWYV"
# natural frequencies (Robinson & Robinson-ish)
FREQ = np.array([7.4, 4.2, 4.4, 5.9, 3.3, 5.8, 3.7, 7.4, 2.9, 3.8, 7.6, 7.2,
                 1.8, 4.0, 5.0, 8.1, 6.2, 1.3, 3.3, 6.8])
FREQ = FREQ / FREQ.sum()


def make(path: str, L: int = 250, n_seq: int = 200, seed: int = 0) -> str:
    """Write an A3M of `n_seq` rows (the query first) and `L` columns; returns path."""
    rng = np.random.default_rng(seed)
    query = rng.choice(list(AA), size=L, p=FREQ)
    lines = [">query T_demo (synthetic CASP-style target)", "".join(query)]
    for i in range(n_seq - 1):
        ident = rng.uniform(0.35, 0.95)  # identity to query
        seq = query.copy()
        mut = rng.random(L) > ident
        seq[mut] = rng.choice(list(AA), size=int(mut.sum()), p=FREQ)
        # gap runs (alignment deletions)
        for _ in range(rng.integers(0, 4)):
            start = rng.integers(0, L - 12)
            seq[start : start + rng.integers(3, 12)] = "-"
        s = "".join(seq)
        # a3m lowercase insertions relative to the query
        if rng.random() < 0.3:
            pos = rng.integers(1, L - 1)
            ins = "".join(rng.choice(list(AA), size=rng.integers(1, 6), p=FREQ)).lower()
            s = s[:pos] + ins + s[pos:]
        lines.append(f">homolog_{i} synthetic")
        lines.append(s)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
