"""On the card, at each fold cell's own sizes: the control (the reference in
the next lower precision put in the program's place) comes out not correct
on three seeds, by the limits the configuration file sets. Run with

    python3 -m pytest -p no:cacheprovider -o addopts="" -m gpu portbench/tests
"""

from __future__ import annotations

import tempfile

import pytest

from portbench import check, run, serve

SEEDS = (2 ** 32 + 101, 2 ** 32 + 202, 2 ** 32 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c["name"] for c in run.manifest()["workloads"]
                                  if run.find_cell(run.manifest(), c["name"])[2]["loop"]
                                  == "fold"])
def test_the_control_is_not_correct(name, cuda_card):
    _, cfg, mix = run.find_cell(run.manifest(), name)
    run.set_caches()
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        fc = serve.FoldCell(cfg, mix, SEEDS[0], cuda_card, tmp)
        fc.setup()
        for i, seed in enumerate(SEEDS):
            if i:
                fc.reseed(seed)
            worst = check.worst_of(fc.control(cfg["control"]).values())
            correct, rows = check.judge(worst, check.limits(cfg, mix))
            assert not correct, (seed, rows)
