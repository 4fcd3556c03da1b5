"""The one generator of the benchmark's traffic: it reads a mix file's
parameters and the run's seed, and nothing else.

A fold mix ("loop": "fold") lists the chain lengths of its cycle, the rows
of each A3M and the rows a request takes. Every seed serves the same
lengths: each cycle is a fresh permutation of them, drawn from the seed,
and each length's A3M is drawn from (seed, L). `check_groups` groups
lengths by the path they take; the check draws one length from each group,
and the last group holds the longest length.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from .a3m import make as make_a3m


def _sub_seed(seed: int, *keys: int) -> int:
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


def fold_files(mix: dict, seed: int, out_dir: str) -> Dict[int, str]:
    """One A3M a distinct length of the cycle, written under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    return {L: make_a3m(os.path.join(out_dir, f"chain_{L}.a3m"), L=L, n_seq=mix["a3m_rows"],
                        seed=_sub_seed(seed, L))
            for L in sorted(set(mix["lengths"]))}


def fold_order(mix: dict, seed: int) -> Iterator[int]:
    """The requests' lengths, cycle after cycle, for ever."""
    rng = np.random.default_rng([seed, 1])
    lengths = list(mix["lengths"])
    while True:
        for i in rng.permutation(len(lengths)):
            yield lengths[i]


def one_cycle(mix: dict, seed: int) -> List[int]:
    it = fold_order(mix, seed)
    return [next(it) for _ in mix["lengths"]]


def check_lengths(mix: dict, seed: int) -> List[int]:
    """One length from each of the mix's check groups, drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    return [int(g[rng.integers(len(g))]) for g in mix["check_groups"]]
