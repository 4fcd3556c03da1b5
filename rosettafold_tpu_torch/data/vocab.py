"""Residue vocabulary: the 20 canonical amino acids, then the gap token."""

from __future__ import annotations

import numpy as np

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"  # 0..19
GAP = 20
VOCAB_SIZE = 21

_CHAR_TO_TOKEN = np.full(256, GAP, dtype=np.int8)
for i, c in enumerate(AA_ORDER):
    _CHAR_TO_TOKEN[ord(c)] = i
    _CHAR_TO_TOKEN[ord(c.lower())] = i
# common non-canonical mappings
_CHAR_TO_TOKEN[ord("B")] = AA_ORDER.index("D")
_CHAR_TO_TOKEN[ord("Z")] = AA_ORDER.index("E")
_CHAR_TO_TOKEN[ord("J")] = AA_ORDER.index("L")
_CHAR_TO_TOKEN[ord("U")] = AA_ORDER.index("C")  # selenocysteine
_CHAR_TO_TOKEN[ord("O")] = AA_ORDER.index("K")  # pyrrolysine


def tokenize(seq: str) -> np.ndarray:
    """Sequence string -> int8 tokens (gap/unknown -> 20)."""
    arr = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    return _CHAR_TO_TOKEN[arr]
