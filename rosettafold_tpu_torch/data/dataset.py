"""File-based training dataset: (A3M, PDB) pairs -> fixed-shape batches (the
port's copy of rosettafold_tpu/data/dataset.py, numpy only).

Every example is cropped and padded to static (n_seq, crop_len) shapes, so
every step of a run sees one batch shape. The train step moves the numpy
arrays to the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .a3m import load_a3m
from .pdb import read_pdb_backbone
from .sampling import subsample_rows
from .vocab import GAP


@dataclasses.dataclass
class Example:
    msa: np.ndarray  # (N, L) int32
    xyz: np.ndarray  # (L, 3, 3) float32
    aa_idx: np.ndarray  # (L,) int32
    mask: np.ndarray  # (L,) bool: valid residues (False = padding)


def load_example(a3m_path: str, pdb_path: str, chain: Optional[str] = None) -> Example:
    tokens = load_a3m(a3m_path)
    xyz, _seq = read_pdb_backbone(pdb_path, chain)
    L = min(tokens.shape[1], xyz.shape[0])
    return Example(msa=tokens[:, :L].astype(np.int32), xyz=xyz[:L],
                   aa_idx=np.arange(L, dtype=np.int32), mask=np.ones(L, bool))


def crop_pad(ex: Example, n_seq: int, crop_len: int, rng: np.random.Generator,
             subsample: str = "uniform") -> Example:
    """Random contiguous crop to crop_len (padded with gap tokens / zeros);
    MSA rows picked by `subsample` (data.sampling) when deeper than n_seq."""
    N, L = ex.msa.shape
    if L > crop_len:
        start = int(rng.integers(0, L - crop_len + 1))
        sl = slice(start, start + crop_len)
        msa, xyz, aa, mask = ex.msa[:, sl], ex.xyz[sl], ex.aa_idx[sl], ex.mask[sl]
    else:
        pad = crop_len - L
        msa = np.pad(ex.msa, ((0, 0), (0, pad)), constant_values=GAP)
        xyz = np.pad(ex.xyz, ((0, pad), (0, 0), (0, 0)))
        aa = np.pad(ex.aa_idx, (0, pad), constant_values=ex.aa_idx[-1] if L else 0)
        mask = np.pad(ex.mask, (0, pad))
    if msa.shape[0] >= n_seq:
        msa = msa[subsample_rows(msa, n_seq, rng, subsample)]
    else:
        msa = np.pad(msa, ((0, n_seq - msa.shape[0]), (0, 0)), constant_values=GAP)
    return Example(msa=msa, xyz=xyz, aa_idx=aa, mask=mask)


def prefetch(it: Iterator[dict], size: int = 2) -> Iterator[dict]:
    """Run `it` on a background thread, keeping up to `size` batches ready;
    a worker exception re-raises at the consuming `next()`."""
    q: queue.Queue = queue.Queue(maxsize=size)
    end, err = object(), object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            q.put((err, e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
            raise item[1]
        yield item


def batches(pairs: Sequence[Tuple[str, str]], batch_size: int = 4, n_seq: int = 16,
            crop_len: int = 128, seed: int = 0, epochs: Optional[int] = None,
            subsample: str = "uniform", process_index: int = 0,
            process_count: int = 1) -> Iterator[dict]:
    """Shuffled fixed-shape batches forever (or for `epochs` passes): msa
    (B, N, L) int32, seq (B, L), aa_idx (B, L), xyz (B, L, 3, 3) float32 and
    mask (B, L).

    Several hosts: pass process_index (the node's rank, torchrun's
    GROUP_RANK), process_count (the node count) and the SAME seed on every
    host. All hosts draw one shared per-epoch permutation from `seed` and
    host i takes the strided slice order[i::process_count]; crops and row
    picks draw from a stream seeded with (seed, process_index). batch_size
    is the host's batch, which `parallel.mesh.shard_batch` splits over the
    host's dp ranks. As JAX's, and process 0's stream is the one-host one."""
    if not (0 <= process_index < process_count):
        raise ValueError(f"process_index {process_index} outside [0, {process_count})")
    shuffle_rng = np.random.default_rng(seed)  # shared: every host's epoch order agrees
    rng = np.random.default_rng((seed, process_index))  # per host
    cache: List[Example] = [load_example(a, p) for a, p in pairs]
    epoch = 0
    while epochs is None or epoch < epochs:
        order = shuffle_rng.permutation(len(cache))[process_index::process_count]
        buf: List[Example] = []
        for i in order:
            buf.append(crop_pad(cache[i], n_seq, crop_len, rng, subsample=subsample))
            if len(buf) == batch_size:
                yield {"msa": np.stack([e.msa for e in buf]),
                       "seq": np.stack([e.msa[0] for e in buf]),
                       "aa_idx": np.stack([e.aa_idx for e in buf]),
                       "xyz": np.stack([e.xyz for e in buf]),
                       "mask": np.stack([e.mask for e in buf])}
                buf = []
        epoch += 1
