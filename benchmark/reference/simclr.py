"""SimCLR-with-saccades, plain: encoder, projector, NT-Xent and the step.

The published method (Chen et al. 2020, arXiv:2002.05709) in the
reference's foveated form: each step of a batch makes ``1 + F`` retina
views; view 0 goes forward in train mode without gradient; then for each
fixation ``j`` the NT-Xent loss (temperature ``τ``) between view ``j−1``'s
projections (detached) and view ``j``'s, its gradient, and one Adam update
at the schedule's rate. NT-Xent follows ``SimCLR/Objective.py``: both views
L2-normalised, the ``aa``/``bb`` blocks masked on the diagonal by −1e9, and
soft cross-entropy over ``[ab, aa]`` and ``[ba, bb]`` summed. The right-hand
operand of every similarity carries no gradient (the reference's
``all_gather`` semantics), so only view ``j`` takes gradient, through the
left operand of ``bb`` and ``ba``. The whole global batch is one batch
here, so BatchNorm statistics and negatives are the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import EXACT
from benchmark.reference.resnet import Projector, ResNet


class SimCLR(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.f = ResNet(cfg["block"], cfg["layers"], 3 * len(cfg["retina"]["crop_sizes"]),
                        residual_gamma=cfg["residual_gamma"])
        fmap = cfg["feature_map"]
        self.g = Projector(self.f.out_channels * fmap * fmap, cfg["projection_hidden"],
                           cfg["projection_dim"])

    def forward(self, glimpses, prec=EXACT):
        return self.g(self.f(glimpses, prec), prec)


def ntxent(h1: torch.Tensor, h2: torch.Tensor, temperature: float, prec=EXACT) -> torch.Tensor:
    h1, h2 = F.normalize(h1, dim=1, eps=1e-12), F.normalize(h2, dim=1, eps=1e-12)
    n = h1.shape[0]
    labels = torch.eye(n, 2 * n, device=h1.device)
    mask = torch.eye(n, device=h1.device) * 1e9

    def sim(a, b):
        return prec.q(a) @ prec.q(b.detach()).T / temperature

    aa, bb = sim(h1, h1) - mask, sim(h2, h2) - mask
    ab, ba = sim(h1, h2), sim(h2, h1)

    def xent(logits):
        return -(labels * F.log_softmax(logits, dim=1)).sum() / n

    return xent(torch.cat([ab, aa], 1)) + xent(torch.cat([ba, bb], 1))


def train_step(model: SimCLR, opt, schedule, count: int, views, temperature: float,
               prec=EXACT, on_first_update=None):
    """One step over ``views`` (``1 + F`` glimpse batches, made lazily by
    ``views(j)``); returns the ``F`` losses and the next update count.
    ``on_first_update(grads)`` sees the gradients of the step's first
    update, as the optimizer gets them."""
    model.train()
    params = opt.params
    with torch.no_grad():
        h1 = model(views(0), prec)
    losses = []
    for j in range(1, views.count):
        h2 = model(views(j), prec)
        loss = ntxent(h1, h2, temperature, prec)
        for p in params.values():
            p.grad = None
        loss.backward()
        if on_first_update is not None and j == 1:
            on_first_update({n: p.grad for n, p in params.items()})
        lr = schedule(count)
        opt.step({n: lr for n in params})
        count += 1
        losses.append(loss.detach())
        h1 = h2.detach()
    return torch.stack(losses), count
