"""Random weights drawn from the run's seed on the device, in a few large
calls, with the scales of the port's `init_like_flax` (flax's defaults):
Dense and Conv kernels lecun-normal (truncated at two standard deviations)
or he-uniform where the module asks for it, zero biases, unit norms, normal
embeddings scaled by 1/sqrt(width), normal(1/sqrt(m_in)) SE(3) 1x1 weights,
normal(1) norm biases. The shapes and names come from the reference's own
model, whose state_dict keys are the port's."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from .reference.models.layers import ConvNHWC, Dense
from .reference.models.se3 import G1x1SE3, GNormBias

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _rules(model: nn.Module) -> List[Tuple[torch.Tensor, str, float]]:
    """(parameter, draw, scale) for every parameter a rule draws; the others
    keep their constant initial values (norm scales 1, shifts 0)."""
    out = []
    for mod in model.modules():
        if isinstance(mod, (Dense, ConvNHWC)):
            fan_in = mod.weight[0].numel()
            if getattr(mod, "he_uniform", False):
                out.append((mod.weight, "uniform", math.sqrt(6.0 / fan_in)))
            else:
                out.append((mod.weight, "trunc", math.sqrt(1.0 / fan_in) / TRUNC_STD))
            if mod.bias is not None:
                out.append((mod.bias, "zero", 0.0))
        elif isinstance(mod, nn.Embedding):
            out.append((mod.weight, "normal", 1.0 / math.sqrt(mod.weight.shape[1])))
        elif isinstance(mod, G1x1SE3):
            for d in mod.degrees:
                W = getattr(mod, f"W_{d}")
                out.append((W, "normal", 1.0 / math.sqrt(W.shape[1])))
        elif isinstance(mod, GNormBias):
            for d in mod.fiber.degrees:
                out.append((getattr(mod, f"bias_{d}"), "normal", 1.0))
    return out


@torch.no_grad()
def draw(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Fill `model`'s parameters in place from `seed` on the parameters'
    device (one normal and one uniform draw in all) and return its
    state_dict. A parameter that no rule draws must hold a constant."""
    rules = _rules(model)
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_normal = sum(p.numel() for p, kind, _ in rules if kind in ("trunc", "normal"))
    n_uniform = sum(p.numel() for p, kind, _ in rules if kind == "uniform")
    normal = torch.randn(n_normal, generator=g, device=dev)
    uniform = torch.rand(n_uniform, generator=g, device=dev)
    i = j = 0
    for p, kind, scale in rules:
        n = p.numel()
        if kind == "zero":
            p.zero_()
        elif kind == "uniform":
            p.copy_(((uniform[j:j + n] * 2 - 1) * scale).view_as(p))
            j += n
        else:
            x = normal[i:i + n]
            if kind == "trunc":
                x = x.clamp(-2.0, 2.0)
            p.copy_((x * scale).view_as(p))
            i += n
    drawn = {id(p) for p, _, _ in rules}
    for name, p in model.named_parameters():
        if id(p) not in drawn and name.rsplit(".", 1)[-1] not in ("weight", "bias"):
            raise RuntimeError(f"no rule draws parameter {name}")
    return model.state_dict()
