"""The readings that the limits of `correct` are set from: for each seed, the
program's numbers (one pass of the cell's mix at its own sizes, the checked
requests captured as in a run) and the control's (the reference in the
next lower precision put in the program's place), in one process.

    python3 -m portbench.calibrate --workload CELL --seeds 1 2 3 ... [--controls K] [--out FILE]

Prints one JSON line a seed: {"seed", "program": {L: numbers},
"control": {L: numbers} (on the first K seeds, all by default), "precision"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import run, serve


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--controls", type=int, default=None,
                   help="run the control on the first K seeds only")
    args = p.parse_args(argv)
    cell, cfg, mix = run.find_cell(run.manifest(), args.workload)
    run.set_caches()
    import torch

    if not torch.cuda.is_available():
        run.fail("no CUDA card")
    out = open(args.out, "a") if args.out else None
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        fc = serve.FoldCell(cfg, mix, args.seeds[0], "cuda", tmp)
        fc.setup()
        for i, seed in enumerate(args.seeds):
            if i:
                fc.reseed(seed)
            fc._serve(serve.plan.one_cycle(mix, seed), None)
            fc.capture_checked()
            rec = {"seed": seed, "program": fc.check(), "precision": cfg["control"]}
            if args.controls is None or i < args.controls:
                rec["control"] = fc.control(cfg["control"])
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    sys.exit(0)


if __name__ == "__main__":
    main()
