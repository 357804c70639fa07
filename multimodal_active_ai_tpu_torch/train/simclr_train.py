"""SimCLR-with-saccades training and evaluation steps.

Port of ``multimodal_active_ai_tpu/train/simclr_train.py:79-203`` (the
reference hot loop ``Contrastive_Learning.py:577-740``). One train step on a
uint8 ``(B, S, S, 3)`` batch:

* builds the mip pyramid once;
* runs one retina call per view, ``1 + num_fixations`` views;
* forwards the first view in train mode under ``no_grad`` (BatchNorm
  statistics update, no gradient);
* then per fixation: NT-Xent between the previous view's projections
  (detached) and this view's, backward, one optimizer update with the
  scheduled learning rate, and the current view becomes the previous one.

It returns the per-fixation loss vector as a device tensor: nothing inside a
step waits for the device. The JAX step is one compiled program; this one
runs eagerly. BatchNorm statistics are the local batch's (single process).

Randomness comes from an explicit ``torch.Generator``. Tests may pass each
view's ``AugParams`` and noise tensor instead, in view order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train.optimizers import set_learning_rate
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy


@dataclass
class TrainState:
    """The model, its optimizer, the schedule and the number of optimizer
    updates made so far (the schedule's argument)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def _view_fn(images: torch.Tensor, cfg: retina.RetinaConfig,
             generator: torch.Generator | None,
             params: Sequence[retina.AugParams] | None,
             noise: Sequence[torch.Tensor] | None):
    """``view(j)`` → glimpses of view ``j`` over a pyramid built once."""
    batch, src = images.shape[0], images.shape[1]
    pyramid = retina.build_pyramid(images, cfg)

    def view(j: int) -> torch.Tensor:
        p = (params[j] if params is not None
             else retina.sample_unlabeled_params(generator, batch, src, cfg))
        return retina.apply_retina(None, p, cfg, photometric=True,
                                   pyramid=pyramid, generator=generator,
                                   noise=None if noise is None else noise[j])

    return view


def make_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                    temperature: float):
    """Returns ``step(state, images, generator=None, params=None,
    noise=None) -> losses`` ``(num_fixations,)``; ``state.step`` advances
    by ``num_fixations``."""

    def step(state: TrainState, images: torch.Tensor,
             generator: torch.Generator | None = None,
             params: Sequence[retina.AugParams] | None = None,
             noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        view = _view_fn(images, retina_cfg, generator, params, noise)
        model, opt = state.model, state.optimizer
        model.train()
        # first saccade: train-mode forward, BN statistics update, no gradient
        with torch.no_grad():
            h1 = model(view(0))
        losses = []
        for j in range(1, num_fixations + 1):
            h2 = model(view(j))
            loss, _, _ = contrastive_loss(h1, h2, temperature=temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            set_learning_rate(opt, state.schedule(state.step))
            opt.step()
            state.step += 1
            losses.append(loss.detach())
            h1 = h2.detach()
        return torch.stack(losses)

    return step


def make_eval_step(retina_cfg: retina.RetinaConfig, temperature: float):
    """Validation step: two eval-mode views, contrastive loss and top-1/top-5
    from ``logits_ab`` (``Contrastive_Learning.py:751-904``). Returns a dict
    of device scalars."""

    def step(state: TrainState, images: torch.Tensor,
             generator: torch.Generator | None = None,
             params: Sequence[retina.AugParams] | None = None,
             noise: Sequence[torch.Tensor] | None = None) -> dict:
        view = _view_fn(images, retina_cfg, generator, params, noise)
        model = state.model
        model.eval()
        with torch.no_grad():
            h1 = model(view(0))
            h2 = model(view(1))
            loss, logits_ab, labels = contrastive_loss(h1, h2, temperature=temperature)
        return {"loss": loss, "top1": top_k_accuracy(logits_ab, labels, 1),
                "top5": top_k_accuracy(logits_ab, labels, 5)}

    return step
