"""SimCLR-with-saccades training and evaluation steps.

Port of ``multimodal_active_ai_tpu/train/simclr_train.py:79-203`` (the
reference hot loop ``Contrastive_Learning.py:577-740``). One train step on a
uint8 ``(B, S, S, 3)`` batch:

* builds the mip pyramid once (``matmul`` mode; the ``fused`` and
  ``canvas`` retinas read the images);
* runs one retina call per view, ``1 + num_fixations`` views;
* forwards the first view in train mode under ``no_grad`` (BatchNorm
  statistics update, no gradient);
* then per fixation: NT-Xent between the previous view's projections
  (detached) and this view's, backward, one optimizer update with the
  scheduled learning rate, and the current view becomes the previous one.

It returns the per-fixation loss vector as a device tensor: nothing inside a
step waits for the device. The JAX step is one compiled program; this one
runs eagerly.

With a process group of N ranks (``parallel/``) each rank holds ``b`` rows
of a global batch of ``N·b`` and the step computes the JAX step of that
global batch: every rank draws the global batch's augmentation parameters
and noise from the same generator and keeps its own rows; the model's
``sync_bn`` layers take the global statistics (view 0's too); NT-Xent takes
its negatives from every rank; each gradient is averaged over the ranks
before each of the F updates; the losses and the eval metrics returned are
the global batch's.

Randomness comes from an explicit ``torch.Generator``. Tests may pass each
view's ``AugParams`` and noise tensor (this rank's rows) instead, in view
order.

Under a profiler each step is a ``trainers.step`` span (its update count
as the span's argument) holding the retina's, the models' and the
collectives' spans and, per update, ``trainers.loss``,
``trainers.backward`` (``zero_grad`` and ``backward``) and
``trainers.update`` (gradient averaging, the schedule and
``optimizer.step``), then ``trainers.metrics``; every train step of
``train/`` uses these names, and an eval step's root is
``trainers.eval_step`` (``utils/profiling.span``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import average_gradients, local_rows, world_size
from multimodal_active_ai_tpu_torch.train.optimizers import set_learning_rate
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy
from multimodal_active_ai_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    """The model, its optimizer, the schedule, the number of updates made
    so far (``step``, the JAX ``TrainState.step``) and the optimizer's own
    update count (``count``, optax's ``count``), which is the schedule's
    argument. The two differ only after a resume that starts the optimizer
    afresh but keeps the step: the schedule then restarts at 0, as optax's
    does."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    count: int = 0


def scheduled_update(state: TrainState) -> None:
    """One optimizer update from the gradients in place, at the schedule's
    rate for ``state.count``; ``step`` and ``count`` advance by one."""
    set_learning_rate(state.optimizer, state.schedule(state.count))
    state.optimizer.step()
    state.step += 1
    state.count += 1


def _view_fn(images: torch.Tensor, cfg: retina.RetinaConfig,
             generator: torch.Generator | None,
             params: Sequence[retina.AugParams] | None,
             noise: Sequence[torch.Tensor] | None):
    """``view(j)`` → glimpses of view ``j`` (``matmul`` mode: over a
    pyramid built once; ``fused``/``canvas``: from the images). The draws
    are the global batch's, in the single-process order (parameters, then
    noise of the mode's :func:`~retina.noise_shape`); this rank keeps its
    rows."""
    src = images.shape[1]
    glob = images.shape[0] * world_size()
    pyramid = retina.build_pyramid(images, cfg) if cfg.mode == "matmul" else None
    shape = retina.noise_shape(cfg, glob)

    def view(j: int) -> torch.Tensor:
        if params is not None:
            p, nz = params[j], None if noise is None else noise[j]
        else:
            p = retina.AugParams(*map(local_rows, retina.sample_unlabeled_params(
                generator, glob, src, cfg)))
            with span("retina.draw"):
                nz = local_rows(torch.randn(shape, generator=generator,
                                            device=generator.device))
        return retina.apply_retina(images, p, cfg, photometric=True,
                                   pyramid=pyramid, generator=generator, noise=nz)

    return view


def make_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                    temperature: float):
    """Returns ``step(state, images, generator=None, params=None,
    noise=None) -> losses`` ``(num_fixations,)``; ``state.step`` and
    ``state.count`` advance by ``num_fixations``."""

    def step(state: TrainState, images: torch.Tensor,
             generator: torch.Generator | None = None,
             params: Sequence[retina.AugParams] | None = None,
             noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        with span("trainers.step", state.step):
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
                with span("trainers.backward"):
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                with span("trainers.update"):
                    average_gradients(model.parameters())
                    scheduled_update(state)
                losses.append(loss.detach())
                h1 = h2.detach()
            with span("trainers.metrics"):
                return mean_across_replicas({"losses": torch.stack(losses)})["losses"]

    return step


def make_eval_step(retina_cfg: retina.RetinaConfig, temperature: float):
    """Validation step: two eval-mode views, contrastive loss and top-1/top-5
    from ``logits_ab`` (``Contrastive_Learning.py:751-904``). Returns a dict
    of device scalars."""

    def step(state: TrainState, images: torch.Tensor,
             generator: torch.Generator | None = None,
             params: Sequence[retina.AugParams] | None = None,
             noise: Sequence[torch.Tensor] | None = None) -> dict:
        with span("trainers.eval_step"):
            view = _view_fn(images, retina_cfg, generator, params, noise)
            model = state.model
            model.eval()
            with torch.no_grad():
                h1 = model(view(0))
                h2 = model(view(1))
                loss, logits_ab, labels = contrastive_loss(h1, h2, temperature=temperature)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss": loss,
                                             "top1": top_k_accuracy(logits_ab, labels, 1),
                                             "top5": top_k_accuracy(logits_ab, labels, 5)})

    return step
