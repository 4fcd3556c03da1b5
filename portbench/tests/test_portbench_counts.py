"""The benchmark's counts against FlopCounterMode run on real tensors."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts.model import FavorProblem, count_forward, peaks
from portbench.reference.config import tiny_config
from portbench.reference.models.rosettafold import RoseTTAFold as Reference
from portbench.reference.ops import performer as favor


@pytest.mark.parametrize("rows,L,heads,dh,m", [(3, 40, 2, 8, 16), (1, 128, 4, 16, 48)])
def test_favor_problem_flops_match_the_plain_math(rows, L, heads, dh, m):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(rows, heads, L, dh, generator=g) for _ in range(3))
    proj = torch.randn(m, dh, generator=g)
    with FlopCounterMode(display=False) as c:
        favor.favor_attention(q, k, v, proj, generalized=True)
    assert FavorProblem(rows, L, heads, dh, m).flops() == c.get_total_flops()


def test_favor_bound_is_the_larger_of_its_two_limits():
    pk = peaks()
    p = FavorProblem(4, 128, 8, 64, 320)
    assert p.bound_s(pk) == max(p.flops() / pk["flops_per_s"]["bfloat16"],
                                p.bytes() / pk["hbm_bytes_per_s"])
    assert p.bytes() == 4 * 4 * 128 * 8 * 64 * 2 + 4 * 320 * 64


@pytest.mark.parametrize("se3_impl", ["dense", "bucket"])
def test_meta_count_equals_a_real_forward(se3_impl):
    cfg = tiny_config(se3_impl=se3_impl)
    L, N = 24, 5
    flops, problems = count_forward(cfg, L, N)
    model = Reference(cfg, seed=1)
    msa = torch.randint(0, 21, (1, N, L))
    with FlopCounterMode(display=False) as c, torch.no_grad():
        model(msa, msa[:, 0], torch.arange(L)[None])
    assert flops == c.get_total_flops() > 0
    assert problems == []  # no attended length reaches the FAVOR+ launch's 128


def test_favor_launches_are_counted_from_128():
    cfg = tiny_config()
    _, problems = count_forward(cfg, 128, 2)
    assert problems and all(p.L == 128 and p.heads * p.dh > 0 for p in problems)
