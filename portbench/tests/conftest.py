"""Shared fixtures of the benchmark's own tests (CPU unless marked `gpu`)."""

from __future__ import annotations

import copy

import pytest

from portbench import run

TINY = dict(d_msa=96, d_pair=72, d_node=32, d_edge=32, d_state=16, n_two_track_blocks=1,
            n_three_track_blocks=2, n_encoder_layers=1, n_neighbors=[8, 8])


def tiny_cell(name: str, lengths=(24, 32, 40), groups=((24, 32), (40,)), rows=12, n_seq=8):
    """(manifest, cell, config, mix) of a committed cell at tiny width and lengths."""
    man = run.manifest()
    cell, cfg, mix = run.find_cell(man, name)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["widths"].update(TINY)
    mix.update(lengths=list(lengths), check_groups=[list(g) for g in groups], a3m_rows=rows,
               n_seq=n_seq)
    return man, cell, cfg, mix


@pytest.fixture
def cuda_card():
    """Skips the test where there is no CUDA card (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
