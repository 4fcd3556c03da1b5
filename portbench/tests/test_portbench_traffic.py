"""The seeded input makers and the one traffic generator."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench.traffic import a3m, pairs, plan
from rosettafold_tpu_torch.data.a3m import load_a3m
from rosettafold_tpu_torch.data.pdb import read_pdb_backbone

BIG = 2 ** 33 + 12345  # seeds run past 32 bits
MIX = json.load(open(os.path.join(os.path.dirname(__file__), "..", "mixes", "short.json")))


def test_a3m_is_a_function_of_the_seed(tmp_path):
    a = a3m.make(str(tmp_path / "a.a3m"), L=70, n_seq=20, seed=BIG)
    b = a3m.make(str(tmp_path / "b.a3m"), L=70, n_seq=20, seed=BIG)
    c = a3m.make(str(tmp_path / "c.a3m"), L=70, n_seq=20, seed=BIG + 1)
    assert open(a).read() == open(b).read() != open(c).read()
    assert load_a3m(a).shape == (20, 70)


def test_pairs_parse_through_the_port(tmp_path):
    got = pairs.make_pairs(str(tmp_path), [40, 55], n_rows=8, seed=BIG)
    for (a, p), L in zip(got, (40, 55)):
        xyz, seq = read_pdb_backbone(p)
        assert xyz.shape == (L, 3, 3) and load_a3m(a).shape == (8, L)
        ca = xyz[:, 1]
        assert np.allclose(np.linalg.norm(np.diff(ca, axis=0), axis=1), 3.8, atol=1e-2)


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_every_seed_serves_the_same_lengths_in_its_own_order(seed):
    it = plan.fold_order(MIX, seed)
    cycles = [[next(it) for _ in MIX["lengths"]] for _ in range(3)]
    for c in cycles:
        assert sorted(c) == sorted(MIX["lengths"])
    assert plan.one_cycle(MIX, seed) == cycles[0]
    checked = plan.check_lengths(MIX, seed)
    assert checked[-1] == max(MIX["lengths"])
    assert all(L in g for L, g in zip(checked, MIX["check_groups"]))


def test_orders_differ_between_seeds():
    assert plan.one_cycle(MIX, 1) != plan.one_cycle(MIX, 2)


def test_files_are_written_where_asked(tmp_path):
    mix = dict(MIX, lengths=[30, 40], a3m_rows=6)
    files = plan.fold_files(mix, BIG, str(tmp_path / "x"))
    assert sorted(files) == [30, 40]
    assert all(os.path.dirname(p) == str(tmp_path / "x") for p in files.values())
