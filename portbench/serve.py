"""The fold cells: one client in a closed loop through
`rosettafold_tpu_torch.predict.predict`, an A3M file in and outputs
synchronised out, one request at a time, as the port serves.

Set-up draws the weights on the card from the seed (`weights.draw` on the
reference's model), builds one program model for each distinct
configuration the mix's lengths need (`presets.program_config`), all
holding the same weight tensors, writes the A3Ms and serves each length
once. The window then serves requests in the seeded order until
`seconds` have passed and the cycle running then is complete; every request
of the window counts. Once it has closed, one more request of each length
the check samples (`plan.check_lengths`) goes through the same entry and
model with `capture.Capture`'s hooks, which keep copies of its stage
outputs; the timed requests carry no hook.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from . import check, presets, weights
from .capture import Capture
from .counts.model import Counts
from .reference.models.rosettafold import RoseTTAFold as Reference
from .trace import span, traced
from .traffic import plan


class FoldCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmp: str):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.tmp = tmp
        self.lengths = sorted(set(mix["lengths"]))
        self.keep = set(plan.check_lengths(mix, seed))
        self.capture = Capture()

    # ---- set-up ---------------------------------------------------------------
    def setup(self):
        from rosettafold_tpu_torch.models.rosettafold import RoseTTAFold

        self.files = plan.fold_files(self.mix, self.seed, os.path.join(self.tmp, "a3m"))
        # MSA rows a request of each length takes, by the reference's featurizer
        self.rows = {L: check.featurize(p, self.mix["n_seq"], self.mix["subsample"])[0].shape[1]
                     for L, p in self.files.items()}
        L_max = max(self.lengths)
        torch.manual_seed(self.seed)
        with torch.device(self.device):
            self.holder = Reference(presets.reference_config(self.cfg, L_max), init=False)
        self.weights = weights.draw(self.holder, self.seed)
        built: Dict[object, object] = {}
        self.models = {}
        for L in self.lengths:
            pc = presets.program_config(self.cfg, L)
            if pc not in built:
                with torch.device(self.device):
                    m = RoseTTAFold(pc, init=False)
                m.load_state_dict(self.weights, strict=True, assign=True)
                built[pc] = m.to(self.device).eval()
            self.models[L] = built[pc]
        self._check_semantics()
        for L in plan.one_cycle(self.mix, self.seed):  # every shape once, seeded order
            self.request(L)

    def reseed(self, seed: int):
        """New weights (drawn in place: every model holds them), A3Ms and
        check sample from `seed`, on the models and kernels set-up built."""
        self.seed = seed
        self.files = plan.fold_files(self.mix, seed, os.path.join(self.tmp, "a3m"))
        self.rows = {L: check.featurize(p, self.mix["n_seq"], self.mix["subsample"])[0].shape[1]
                     for L, p in self.files.items()}
        weights.draw(self.holder, seed)
        self.keep = set(plan.check_lengths(self.mix, seed))
        self.capture = Capture()

    def _check_semantics(self):
        for L, m in self.models.items():
            want = presets.semantic_fields(presets.reference_config(self.cfg, L))
            got = presets.semantic_fields(m.config)
            if want != got:
                diff = {k: (got[k], want[k]) for k in want if got.get(k) != want[k]}
                raise RuntimeError(f"L={L}: the program's preset departs from the "
                                   f"configuration file: {diff}")

    # ---- requests -------------------------------------------------------------
    def request(self, L: int, capture: bool = False):
        from rosettafold_tpu_torch.predict import predict

        model = self.models[L]
        handles = self.capture.hooks(model, L) if capture else []
        try:
            logits, xyz, plddt, _, _ = predict(
                self.files[L], n_seq=self.mix["n_seq"], subsample=self.mix["subsample"],
                device=self.device, model=model)
        finally:
            for h in handles:
                h.remove()
        return logits, xyz, plddt

    def _serve(self, lengths, deadline_s):
        """Serve `lengths` in order until deadline_s after the start and the
        end of a whole cycle of the mix (deadline None: all of them). Whole
        cycles give
        every run the same mix of lengths, so the tail does not move with
        where the window happens to cut a cycle."""
        recs = []
        cycle = len(self.mix["lengths"])
        t_start = time.perf_counter()
        for L in lengths:
            t0 = time.perf_counter()
            with span(f"portbench.request L={L}"):
                self.request(L)
            t1 = time.perf_counter()
            recs.append((L, t1 - t0))
            if (deadline_s is not None and t1 - t_start >= deadline_s
                    and len(recs) % cycle == 0):
                break
        return recs, time.perf_counter() - t_start

    def window(self, seconds: float):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        recs, window_s = self._serve(plan.fold_order(self.mix, self.seed), seconds)
        self.window_peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        return recs, window_s

    def traced_pass(self):
        """One cycle of the mix, in the seeded order, under the profiler."""
        order = plan.one_cycle(self.mix, self.seed)
        (recs, _), tr = traced(lambda: self._serve(order, None), self.device.type == "cuda")
        return recs, tr

    def capture_checked(self):
        """After the window: one request of each sampled length through the
        same entry and model, its stages captured."""
        for L in sorted(self.keep):
            self.request(L, capture=True)

    def free(self):
        self.models.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check --------------------------------------------------------------
    def check(self):
        """{L: numbers} of the captured requests."""
        out = {}
        for L in sorted(self.keep):
            out[L] = check.stage_gaps(self.cfg, self.weights, self.files[L], self.mix["n_seq"],
                                      self.mix["subsample"], self.device, self.capture.result(L))
            self.capture.drop(L)
        return out

    def control(self, precision: str):
        """{L: numbers} of the control: the reference in `precision` in the
        program's place, on the lengths the check samples."""
        out = {}
        for L in sorted(self.keep):
            cap = check.control_capture(self.cfg, self.weights, self.files[L], self.mix["n_seq"],
                                        self.mix["subsample"], self.device, precision)
            out[L] = check.stage_gaps(self.cfg, self.weights, self.files[L], self.mix["n_seq"],
                                      self.mix["subsample"], self.device, cap)
        return out


def end_to_end(recs: List[tuple], window_s: float, peak_bytes: int) -> Dict[str, float]:
    lat_ms = np.array([r[1] for r in recs]) * 1e3
    return {
        "fold_p90_ms": float(np.percentile(lat_ms, 90)),
        "fold_pairs_per_s": float(sum(L * L for L, _ in recs) / window_s),
        "peak_mem_gib": peak_bytes / 2 ** 30,
    }


def _count(cell: FoldCell, L: int, counts: Counts):
    return counts.forward(presets.reference_config(cell.cfg, L), L, cell.rows[L])


def model_flops(cell: FoldCell, recs, counts: Counts) -> float:
    return float(sum(_count(cell, L, counts)[0] for L, _ in recs))


def favor_bound_s(cell: FoldCell, recs, counts: Counts, pk: dict) -> float:
    return math.fsum(p.bound_s(pk) for L, _ in recs for p in _count(cell, L, counts)[1])
