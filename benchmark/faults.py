"""Faults planted in the program to show that the comparison catches them.

Each is applied to a built kind, under the timed path:

* ``frozen_state``: every update restores the parameters it changed, so a
  step returns its state unchanged;
* ``half_batch``: the step is fed the first half of this rank's rows and
  takes its mean over them (the kind slices its inputs);
* ``half_loss``: the step's forward pass is whole, but its loss is the
  mean over the first half of the rows (SimCLR: NT-Xent over the first
  half of each view's rows; DETR: the kind wraps the criterion it hands the
  step builder with :func:`half_loss`);
* ``no_exchange``: the gradient all-reduce between ranks is left out.

The harness's ``--fault`` and the CPU tests use them; no measured run does.
"""

from __future__ import annotations

import torch

FAULTS = ("frozen_state", "half_batch", "half_loss", "no_exchange")


def plant(kind, fault: str | None):
    """Plant ``fault`` in ``kind``'s program; returns what undoes it."""
    if fault == "half_loss" and hasattr(kind.train_module, "contrastive_loss"):
        module, loss = kind.train_module, kind.train_module.contrastive_loss

        def half(h1, h2, **kwargs):
            n = h1.shape[0] // 2
            return loss(h1[:n], h2[:n], **kwargs)

        module.contrastive_loss = half
        return lambda: setattr(module, "contrastive_loss", loss)
    if fault in (None, "half_batch", "half_loss"):
        return lambda: None
    if fault == "frozen_state":
        opt = kind.optimizer
        update = opt.step

        def step(*args, **kwargs):
            params = [p for g in opt.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            out = update(*args, **kwargs)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out

        opt.step = step
        return lambda: None
    if fault == "no_exchange":
        module, exchange = kind.train_module, kind.train_module.average_gradients
        module.average_gradients = lambda params: None
        return lambda: setattr(module, "average_gradients", exchange)
    raise SystemExit(f"unknown fault {fault!r}; one of {FAULTS}")


def half_loss(criterion):
    """``criterion`` over the first half of the rows of its predictions and
    labels only."""

    def half(pred, labels):
        n = pred.shape[0] // 2
        return criterion(pred[:n], labels[:n])

    return half
