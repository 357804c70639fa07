"""Optimizers and learning-rate schedules, plain.

Adam as torch and optax define it (β = (0.9, 0.999), ε = 1e-8 outside the
root, bias-corrected): ``m ← β1·m + (1−β1)·g``, ``v ← β2·v + (1−β2)·g²``,
``p ← p − lr·(m / (1−β1ᵗ)) / (√(v / (1−β2ᵗ)) + ε)``. AdamW first decays
``p ← p·(1 − lr·wd)``. The DETR chain clips by the global norm of every
gradient (``g ← g·min(1, max_norm / ‖g‖)``) before AdamW. Schedules are a
frozen copy of the documented arithmetic: SimCLR's linear-scaled warm-up
and cosine decay over the updates counted from 0, and DETR's StepLR factor.
"""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay: float = 0.0):
        self.params = params
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, lrs: dict[str, float]):
        """One update of every parameter at its rate ``lrs[name]``."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g, lr = p.grad, lrs[n]
            if self.wd:
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def simclr_schedule(base_lr: float, global_batch: int, num_examples: int, batch: int,
                    warmup_epochs: int, epochs: int):
    """``lr(count)``: ``base·global/256``, linear warm-up over
    ``warmup·examples // batch`` updates from 0, then cosine decay to the
    ``examples·epochs // batch + 1``-th; ``examples`` and ``batch`` are a
    rank's shard and batch."""
    lr = base_lr * global_batch / 256.0
    warmup = int(round(warmup_epochs * num_examples // batch))
    decay = max(num_examples * epochs // batch + 1 - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return count / warmup * lr
        return lr * 0.5 * (1 + math.cos(math.pi * min(count - warmup, decay) / decay))

    return schedule


def step_lr(steps_per_epoch: int, lr_drop_epochs: int):
    """StepLR's factor of update ``count``: ``0.1^(epoch // lr_drop)``."""
    return lambda count: 0.1 ** ((count // max(steps_per_epoch, 1)) // lr_drop_epochs)
