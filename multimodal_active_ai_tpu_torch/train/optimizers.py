"""Optimizer construction: sgd / adam / lars.

Port of ``multimodal_active_ai_tpu/train/optimizers.py`` (reference
``SimCLR/Model_Util.py:68-88``), with the update arithmetic of the optax
chains the JAX package builds:

* ``sgd``: weight decay added to the gradient, then heavy-ball momentum
  (``optax.chain(add_decayed_weights, sgd(momentum))`` = ``torch.optim.SGD``
  with ``weight_decay`` and ``dampening=0``);
* ``adam``: ``torch.optim.Adam`` with optax's β = (0.9, 0.999), ε = 1e-8;
* ``lars``: Adam wrapped in apex ``LARC`` (clip mode, trust coefficient
  η = 0.02): each parameter's Adam step is scaled by
  ``min(1, η·‖p‖ / (‖step‖ + 1e-8))`` when both norms are positive.

The learning rate is set per update from the schedule by the trainer
(:func:`set_learning_rate`), as optax evaluates its schedule per update.
"""

from __future__ import annotations

from typing import Iterable

import torch


class LARCAdam(torch.optim.Optimizer):
    """Adam with the apex-LARC adaptive trust ratio in clip mode
    (``optax.chain(scale_by_adam(), larc_scale(), scale_by_learning_rate)``)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 trust_coefficient: float = 0.02, trust_eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      trust_coefficient=trust_coefficient,
                                      trust_eps=trust_eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARCAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                update = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + group["eps"])
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(update)
                ratio = torch.where((pn > 0) & (un > 0),
                                    group["trust_coefficient"] * pn / (un + group["trust_eps"]),
                                    1.0)
                p.add_(update * torch.clamp_max(ratio, 1.0), alpha=-group["lr"])


def get_optimizer(name: str, params: Iterable, momentum: float = 0.9,
                  weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """sgd / adam / lars with the reference's wiring (SGD takes momentum and
    weight decay, Adam and LARS only the learning rate). The initial
    learning rate is 0; the trainer sets it per update."""
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if name == "lars":
        return LARCAdam(params, lr=0.0)
    if name in ("adamw", "rmsprop"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP: the DETR and "
            "RLS slices)")
    raise ValueError(f"Unknown optimizer {name}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
