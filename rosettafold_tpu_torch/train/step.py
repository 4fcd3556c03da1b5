"""Train step, eval step and forward (port of rosettafold_tpu/train/step.py).

The optimizer is optax's chain(clip_by_global_norm(grad_clip),
adamw(lr, weight_decay, mu_dtype)) inside MultiSteps(accum_steps), written out
(`OptaxAdamW`): clipping scales by max_norm / norm only when norm > max_norm,
and with moment_dtype="bfloat16" the first moment is stored in bfloat16 as
optax's mu_dtype does.

Dropout: nn.Dropout draws from the default generators. Each step forks them
and seeds them from (seed, step), the counterpart of JAX's
fold_in(rng, step); `torch.utils.checkpoint` saves and restores the same
generators, so a remat'd block's recomputation draws the forward's masks.

Under a mesh (parallel/mesh.py, made current by `use_mesh`): the seed also
folds in the rank's dp coordinate (its examples draw their own masks; the
ranks of a tp group draw the same, so the replicated activations agree);
the gradients are reduced to the global batch's (`mesh.reduce_gradients`);
the metrics are summed over dp; the clip reads the norm of the whole
gradient, a tp-sharded leaf's squares summed over its group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.rosettafold import RoseTTAFold
from ..parallel import mesh as pmesh
from .losses import rosettafold_loss


def global_norm(tensors, params=None) -> torch.Tensor:
    """optax.global_norm of the whole gradient whose local parts are
    `tensors` (of `params`, where given): sqrt of the replicated leaves'
    squares plus the tp-sharded leaves' squares summed over their group.
    Without a tp mesh no leaf is sharded and the sum over tp is the identity."""
    def squares(ts):
        if not ts:
            return torch.zeros((), device=tensors[0].device)
        return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()

    params = params or [None] * len(tensors)
    sharded = [t for p, t in zip(params, tensors) if pmesh.tp_dim(p) is not None]
    replicated = [t for p, t in zip(params, tensors) if pmesh.tp_dim(p) is None]
    return torch.sqrt(squares(replicated) + pmesh.tp_sum(squares(sharded)))


class OptaxAdamW(torch.optim.Optimizer):
    """optax.MultiSteps(chain(clip_by_global_norm(grad_clip), adamw(lr, b1,
    b2, eps, weight_decay=weight_decay, mu_dtype)), accum_steps).

    Every `step()` is one MultiSteps call: the gradients join a float32
    running mean, and each `accum_steps`-th call applies it:
    global-norm clip, Adam moments (the first in `mu_dtype`), bias
    correction, decoupled weight decay, -lr. Between updates the parameters
    stay as they are, as optax's MultiSteps returns zero updates then."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
                 grad_clip=1.0, accum_steps=1, mu_dtype=torch.float32):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.grad_clip, self.accum_steps, self.mu_dtype = grad_clip, accum_steps, mu_dtype
        self.mini_step = 0  # MultiSteps' position inside the accumulation window
        self.count = 0      # Adam's update count

    def _params(self):
        return [p for group in self.param_groups for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def step(self, closure=None, grad_norm=None):
        """One MultiSteps call. `grad_norm`: the global norm of the current
        gradients where the caller has it; with accum_steps == 1 those are
        the gradients clipped, so it is not computed again."""
        params = self._params()  # float32 parameters, one group
        if self.accum_steps > 1:  # MultiSteps' running mean (Welford)
            n = self.mini_step
            for p in params:
                acc = self.state[p].setdefault("acc_grad", torch.zeros_like(p, dtype=torch.float32))
                acc.add_((p.grad.float() - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return None
            self.mini_step = 0
            grads = [self.state[p]["acc_grad"].clone() for p in params]
            for p in params:
                self.state[p]["acc_grad"].zero_()
            grad_norm = None  # the clip reads the mean's norm
        else:
            grads = [p.grad.float() for p in params]
        norm = global_norm(grads, params) if grad_norm is None else grad_norm
        # optax: below max_norm the update as it is, else (g / norm) * max_norm;
        # selected on the device, so the step waits for no host read
        keep = norm < self.grad_clip
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip))
        self.count += 1
        group = self.param_groups[0]
        b1, b2, eps, lr, wd = (group[k] for k in ("b1", "b2", "eps", "lr", "weight_decay"))
        for p in params:
            if "mu" not in self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                self.state[p]["nu"] = torch.zeros_like(p, dtype=torch.float32)
        states = [self.state[p] for p in params]
        # mu = (1 - b1) g + b1 mu as the jitted optax step computes it: b1
        # rounded to the moment's dtype (a weakly typed Python float), the
        # sum in float32; nu = (1 - b2) g^2 + b2 nu
        mu = torch._foreach_mul([st["mu"].float() for st in states],
                                float(torch.tensor(b1, dtype=self.mu_dtype)))
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        nu = torch._foreach_mul([st["nu"] for st in states], b2)
        torch._foreach_add_(nu, g2)
        # update = mu_hat / (sqrt(nu_hat) + eps) + wd p; p += -lr update
        den = torch._foreach_div(nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        for st, m, n in zip(states, mu, nu):
            st["mu"], st["nu"] = m.to(self.mu_dtype), n
        return None

    def state_dict(self):
        sd = super().state_dict()
        sd["multi_steps"] = {"mini_step": self.mini_step, "count": self.count}
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        extra = state_dict.pop("multi_steps")
        super().load_state_dict(state_dict)  # casts the state to the parameters' dtype
        for st in self.state.values():
            if "mu" in st:
                st["mu"] = st["mu"].to(self.mu_dtype)
        self.mini_step, self.count = extra["mini_step"], extra["count"]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state) and the step."""

    model: RoseTTAFold
    optimizer: OptaxAdamW
    step: int = 0


def create_train_state(config, seed: int = 0, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-4, grad_clip: float = 1.0,
                       accum_steps: int = 1, moment_dtype: str = "float32",
                       device="cuda", mesh=None) -> TrainState:
    """A model with random weights from `seed` (models.rosettafold.init_like_flax),
    in training mode on `device`, and its optimizer. accum_steps > 1 applies
    the mean gradient of that many calls per update; moment_dtype="bfloat16"
    keeps Adam's first moment in bfloat16. With a tp `mesh` the model keeps
    this rank's shards of the leaves the tp rules match (every rank draws the
    same full model from `seed` first), and the optimizer, made after, holds
    moments of the local shapes, as JAX's moments mirror its layout."""
    model = RoseTTAFold(config, device=device, seed=seed)
    model.train()
    if mesh is not None:
        pmesh.shard_params(model, mesh)
    mu_dtype = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    opt = OptaxAdamW(model.parameters(), lr=learning_rate, weight_decay=weight_decay,
                     grad_clip=grad_clip, accum_steps=accum_steps, mu_dtype=mu_dtype)
    return TrainState(model=model, optimizer=opt)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A numpy batch (data.dataset.batches) as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def step_seed(seed: int, step: int, dp_rank: int = 0) -> int:
    """The dropout seed of one step: a function of (seed, step) and, from
    dp coordinate 1 on, the rank's dp coordinate."""
    key = [seed, step] + ([dp_rank] if dp_rank else [])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def _forward_loss(model, batch):
    outputs = model(batch["msa"], batch["seq"], batch["aa_idx"])
    return rosettafold_loss(outputs, batch["xyz"], residue_mask=batch.get("mask"))


def make_train_step(config):
    """train_step(state, batch, seed) -> (state, metrics): one optimizer call
    on a batch of tensors (to_device; under a mesh this rank's rows,
    `mesh.shard_batch`). metrics: the loss terms, "total" and "grad_norm"
    (the global norm of this batch's gradients), as tensors, of the global
    batch."""

    def train_step(state: TrainState, batch, seed: int) -> Tuple[TrainState, Dict]:
        model, opt = state.model, state.optimizer
        model.train()
        dev = next(model.parameters()).device
        m = pmesh.current()
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(step_seed(seed, state.step, m.dp_rank if m else 0))
            opt.zero_grad(set_to_none=True)
            loss, metrics = _forward_loss(model, batch)
            loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        pmesh.reduce_gradients(params)
        grads = [p.grad for p in params]
        metrics = {k: pmesh.dp_sum(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads, params)
        opt.step(grad_norm=metrics["grad_norm"])
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(config):
    """eval_step(model, batch) -> metrics, in eval mode without gradients."""

    @torch.no_grad()
    def eval_step(model, batch):
        was = model.training
        model.eval()
        try:
            return {k: pmesh.dp_sum(v.detach())
                    for k, v in _forward_loss(model, batch)[1].items()}
        finally:
            model.train(was)

    return eval_step


def make_forward(config):
    """forward(model, msa, seq, aa_idx) -> (logits, xyz, plddt), inference."""

    @torch.no_grad()
    def forward(model, msa, seq, aa_idx):
        was = model.training
        model.eval()
        try:
            return model(msa, seq, aa_idx)
        finally:
            model.train(was)

    return forward
