"""The fold loop: one client serving A3M files through `predict` (serve.py)."""

from __future__ import annotations

import sys
import time

import torch

from .. import metrics as readers
from .. import serve
from ..counts.model import Counts, peaks
from ..readers import Context


def run(args, cell, cfg, mix, man, tmp, device, t_start):
    cuda = torch.device(device).type == "cuda"
    fc = serve.FoldCell(cfg, mix, args.seed, device, tmp)
    fc.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    extra, breakdown = {}, None
    if not args.trace:
        recs, window_s = fc.window(args.seconds)
        values = serve.end_to_end(recs, window_s, fc.window_peak)
        values["setup_s"] = setup_s
    else:
        recs, tr = fc.traced_pass()
        window_s = tr.window_s
        pk = peaks()
        counts = Counts()
        ctx = Context(trace=tr, items=len(recs), model_flops=serve.model_flops(fc, recs, counts),
                      peak_flops=pk["flops_per_s"][cfg["semantics"]["compute_dtype"]],
                      favor_bound_s=serve.favor_bound_s(fc, recs, counts, pk))
        values = {}
        for m in readers.of_cell(man, cell["name"], "per_layer"):
            v = readers.load(m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": [list(x) for x in tr.top_device_ops()],
                     "idle_gaps": [list(x) for x in tr.idle_gaps()]}
    extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    t_check = time.monotonic()
    fc.capture_checked()
    fc.free()
    readings = fc.check()
    print(f"portbench: set-up {setup_s:.1f} s, {len(recs)} requests in {window_s:.1f} s, "
          f"check {time.monotonic() - t_check:.1f} s", file=sys.stderr)
    return len(recs), 0, values, extra, breakdown, readings
