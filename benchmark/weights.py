"""Weights made from the seed, on the device, in one draw.

The reference's modules state how each tensor starts (``init_plan``:
constants set in place, and ``(tensor, std)`` pairs for normal draws).
All the normal draws come from one ``torch.randn`` on a generator seeded
with ``--seed``, each slice clamped at ±2 and scaled by its std; the
result is a state dict with the reference checkpoint's names, which loads
into the program and into the reference alike.
"""

from __future__ import annotations

import torch
from torch import nn


def fill(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters and buffers in place from ``seed``."""
    plan = []
    for mod in model.modules():
        if hasattr(mod, "init_plan"):
            plan += mod.init_plan()
    device = plan[0][0].device
    total = sum(t.numel() for t, _ in plan)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    with torch.no_grad():
        for t, std in plan:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t).clamp_(-2.0, 2.0).mul_(std))
            at += n
    return model


def make(cls, cfg: dict, seed: int, device) -> nn.Module:
    """``cls(cfg)`` built on ``device`` with its weights from ``seed``."""
    with torch.device(device):
        model = cls(cfg)
    return fill(model, seed)
