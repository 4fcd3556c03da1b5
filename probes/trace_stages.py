"""Where a fold request's time goes, stage by stage, on the card.

    python3 probes/trace_stages.py --workload fold-short --seed N [--passes 2] [--out FILE]

Sets a benchmark cell up as `portbench.run` does (same weights, A3Ms and
models from the seed), runs its traced pass `--passes` times and prints, for
each pass, one JSON line: the pass's window and busy seconds, the device-idle
ms a request, the readers of the program's spans (`entry_ms`,
`dispatch_idle_ms`), each request's offset of the device's clock against the
host spans (`portbench.spans.offsets`) and one row a program span
(`portbench.spans.stage_table`: host ms, device-idle ms and kernel launches a
request). A last line gives the
cost of one `tracing.span` with the profiler off and recording, in us, over
many calls on the host. `--out` also writes the lines to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_cost_us(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rosettafold_tpu_torch.tracing import span

    def one():
        with span("rf.probe"):
            pass

    off = timeit.timeit(one, number=n_off) / n_off * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = timeit.timeit(one, number=n_on) / n_on * 1e6
    torch.cuda.synchronize()
    return {"span_off_us": off, "span_on_us": on}


def passes(fc, n: int) -> list:
    """n traced passes of the set-up FoldCell `fc`, one dict each."""
    from portbench import spans
    from portbench.readers import Context

    out = []
    for i in range(n):
        recs, tr = fc.traced_pass()
        ctx = Context(trace=tr, items=len(recs), model_flops=0.0, peak_flops=1.0)
        out.append({
            "pass": i, "items": len(recs), "window_s": tr.window_s, "busy_s": tr.busy_s,
            "idle_ms_a_request": (tr.window_s - tr.busy_s) * 1e3 / len(recs),
            "entry_ms": spans.entry_ms(ctx), "dispatch_idle_ms": spans.dispatch_idle_ms(ctx),
            "launches_a_request": ctx.launches_per_item(), "idle_gaps": tr.idle_gaps(),
            "offsets_ms": [round(d / 1e6, 3) for _, _, d in spans.offsets(tr)],
            "stages": spans.stage_table(tr, len(recs))})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import run
    from portbench.serve import FoldCell

    if not torch.cuda.is_available():
        print("trace_stages: no CUDA card", file=sys.stderr)
        return 1
    cell, cfg, mix = run.find_cell(run.manifest(), args.workload)
    run.set_caches()
    with tempfile.TemporaryDirectory(prefix="trace-stages-") as tmp:
        fc = FoldCell(cfg, mix, args.seed, "cuda", tmp)
        fc.setup()
        lines = [{"workload": args.workload, "seed": args.seed, **x}
                 for x in passes(fc, args.passes)]
    lines.append({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                  **span_cost_us()})
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
