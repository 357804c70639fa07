"""DETR classifier fine-tuning: glimpse-sequence collection and the steps.

Port of ``multimodal_active_ai_tpu/train/detr_train.py`` (reference
``DETR_Image_Classification.py:538-763``). Per batch a number of fixations
``num_fixs ∈ [1, F]`` is drawn once, the ``F`` glimpses of every image are
collected through the labeled retina at random saccades in one
``apply_retina_views`` call (one glimpse sampler launch), positions
``≥ num_fixs`` are padding, and the DETR head is trained with AdamW.

The optimizer follows the JAX package's ``make_detr_optimizer``
(``optax.chain(clip_by_global_norm, multi_transform(...))``):

* parameter groups ``head`` (learning rate ``lr``), ``backbone`` (the
  encoder's layer2-4, ``lr_backbone``) and ``frozen`` (its stem and
  layer1), which no update touches; every parameter is ``head`` when no
  pretrained backbone was loaded;
* the global gradient norm counts **every** gradient, the ``frozen`` ones
  included: they stay differentiable (the reference sets
  ``requires_grad_(False)`` on them instead) and are left out of the
  optimizer's groups;
* StepLR: ``lr·0.1^((step // steps_per_epoch) // lr_drop)``, set on each
  group before each update.

Randomness comes from explicit ``torch.Generator``s: one for the glimpse
draws (tests may hand in ``num_fixs`` and the saccades instead) and, in
the train step, one for the transformer's dropout (the JAX step's
``dropout`` key).

With several ranks (``parallel/``) ``num_fixs`` and the saccades are drawn
for the global batch and each rank keeps its rows, every gradient (the
``frozen`` ones too, which the clip's norm counts) is averaged over the
ranks before the clip, as optax clips the gradient of the global batch,
the dropout masks are the global batch's draws (``models/transformer.py``)
and the returned metrics are the global batch's.
"""

from __future__ import annotations

import torch

from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import average_gradients, local_rows, world_size
from multimodal_active_ai_tpu_torch.train.optimizers import get_optimizer
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy
from multimodal_active_ai_tpu_torch.utils.profiling import span

BODY = "backbone.0.body."


def detr_param_labels(model: torch.nn.Module, pretrained_backbone: bool = True) -> dict:
    """``{name: 'head' | 'backbone' | 'frozen'}`` for every parameter: the
    ``BackboneBase`` freezing rule (``backbone.py:78-80``) and the AdamW
    groups (``DETR_Image_Classification.py:385-394``) for a pretrained
    backbone; all ``head`` for a run from scratch, where freezing an
    untrained stem would pin the model at the uniform-prior loss."""
    labels = {}
    for name, _ in model.named_parameters():
        label = "head"
        if pretrained_backbone and name.startswith(BODY):
            trainable = name[len(BODY):].startswith(("layer2", "layer3", "layer4"))
            label = "backbone" if trainable else "frozen"
        labels[name] = label
    return labels


def make_detr_optimizer(model: torch.nn.Module, lr: float, lr_backbone: float,
                        weight_decay: float,
                        pretrained_backbone: bool = True) -> torch.optim.AdamW:
    """AdamW over the ``head`` and ``backbone`` groups (each group's
    ``base_lr`` is its undecayed rate); ``frozen`` parameters are in no
    group."""
    labels = detr_param_labels(model, pretrained_backbone)
    named = dict(model.named_parameters())
    groups = [{"params": [named[n] for n, lab in labels.items() if lab == label],
               "name": label, "base_lr": base}
              for label, base in (("head", lr), ("backbone", lr_backbone))]
    return get_optimizer("adamw", [g for g in groups if g["params"]],
                         weight_decay=weight_decay)


def step_lr(steps_per_epoch: int, lr_drop_epochs: int):
    """The StepLR factor of update ``step``: ``0.1^(epoch // lr_drop)``."""
    def factor(step: int) -> float:
        return 0.1 ** ((step // max(steps_per_epoch, 1)) // lr_drop_epochs)
    return factor


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: gradients scale by ``max_norm / norm`` when the global norm is at
    least ``max_norm`` (``max_norm`` ≤ 0: no clip). Returns the norm before
    clipping, a float32 device scalar. Each tensor's sum of squares
    accumulates in float64: torch's float32 norm on the CPU drifts by
    ~1e-4 relative over a few million elements, XLA's does not."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        grads, 2, dtype=torch.float64))).to(grads[0].dtype)
    if max_norm and max_norm > 0:
        torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


def apply_update(state: TrainState, loss: torch.Tensor, clip_max_norm: float) -> torch.Tensor:
    """One update of the DETR optimizer chain on ``loss``: backward, the
    gradient averaged over ranks, then :func:`update_from_grads`. Returns
    the norm before clipping."""
    with span("trainers.backward"):
        state.model.zero_grad(set_to_none=True)
        loss.backward()
    with span("trainers.update"):
        average_gradients(state.model.parameters())
        return update_from_grads(state, clip_max_norm)


def update_from_grads(state: TrainState, clip_max_norm: float) -> torch.Tensor:
    """The optimizer chain on the gradients in place: the global-norm clip
    over every gradient, each group's StepLR rate at ``state.count`` (the
    AdamW count the JAX schedule reads), AdamW; ``state.step`` and
    ``state.count`` advance by one. Returns the norm before clipping."""
    with span("trainers.clip"):
        norm = clip_by_global_norm_(state.model.parameters(), clip_max_norm)
    factor = state.schedule(state.count)
    for group in state.optimizer.param_groups:
        group["lr"] = group["base_lr"] * factor
    state.optimizer.step()
    state.step += 1
    state.count += 1
    return norm


@torch.no_grad()
def collect_glimpse_sequence(images: torch.Tensor, retina_cfg: retina.RetinaConfig,
                             num_fixations: int, generator: torch.Generator | None = None,
                             min_fixations: int = 1, saccades: torch.Tensor | None = None,
                             num_fixs: int | torch.Tensor | None = None):
    """``F`` labeled glimpses per image at random (or given) saccades.

    Equivalent of ``DETR_Image_Classification.py:560-584``: ``num_fixs ∈
    [min_fixations, F]`` is drawn once per batch (or given) and becomes a
    pad mask over the static ``F``; the saccades ``(B, F, 2)`` are drawn
    ~ U[0,1)² (or given), stored (x, y) and fed to the retina as (y, x).
    All ``F·B`` plan rows, view-major, go to the sampler in one call
    (``matmul`` mode; the ``fused`` and ``canvas`` retinas take one call a
    fixation).
    Returns ``(glimpses (B, F, g, g, 12), saccades (B, F, 2), mask (B, F))``
    with True on padded positions.
    """
    batch, src = images.shape[0], images.shape[1]
    with span("retina.draw"):
        if num_fixs is None:
            num_fixs = torch.randint(min_fixations, num_fixations + 1, (),
                                     generator=generator, device=generator.device)
        if saccades is None:
            glob = torch.rand((num_fixations, batch * world_size(), 2), generator=generator,
                              device=generator.device)
            saccades = local_rows(glob, 1).transpose(0, 1)
    if retina_cfg.mode == "matmul":
        pyramid = retina.build_pyramid(images, retina_cfg)
        fix_xy = saccades.transpose(0, 1).reshape(num_fixations * batch, 2)
        params = retina.sample_labeled_params(None, num_fixations * batch, src,
                                              fix_yx=fix_xy.flip(-1))
        g = retina.apply_retina_views(pyramid, params, retina_cfg, photometric=False)
        glimpses = g.reshape((num_fixations, batch) + g.shape[1:]).transpose(0, 1)
    else:
        # fused/canvas: one retina call a fixation, as in the JAX package
        glimpses = torch.stack([retina.apply_retina(
            images, retina.sample_labeled_params(None, batch, src,
                                                 fix_yx=saccades[:, j].flip(-1)),
            retina_cfg, photometric=False) for j in range(num_fixations)], dim=1)
    positions = torch.arange(num_fixations, device=images.device)
    mask = (positions >= torch.as_tensor(num_fixs, device=images.device))
    return glimpses, saccades, mask[None].expand(batch, num_fixations)


def make_detr_train_step(criterion, retina_cfg: retina.RetinaConfig,
                         num_fixations: int, clip_max_norm: float):
    """``train_classifier`` equivalent (``DETR_Image_Classification.py:
    538-654``). Returns ``step(state, images, labels, generator=None,
    num_fixs=None, saccades=None, dropout_generator=None) -> {"loss_ce",
    "class_error", "grad_norm"}`` (device scalars; ``grad_norm`` before
    clipping); ``dropout_generator`` draws the transformer's dropout (needed
    when its rate is above 0); ``state.schedule`` is :func:`step_lr`'s
    factor and ``state.step`` advances by one update."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None, num_fixs=None,
             saccades: torch.Tensor | None = None,
             dropout_generator: torch.Generator | None = None) -> dict:
        with span("trainers.step", state.step):
            glimpses, sacc, mask = collect_glimpse_sequence(
                images, retina_cfg, num_fixations, generator, saccades=saccades,
                num_fixs=num_fixs)
            state.model.train()
            pred = state.model(glimpses, sacc, mask, dropout_generator)["pred_logits"]
            losses = criterion(pred, labels)
            norm = apply_update(state, losses["loss_ce"], clip_max_norm)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss_ce": losses["loss_ce"].detach(),
                                             "class_error": losses["class_error"],
                                             "grad_norm": norm})

    return step


def make_detr_eval_step(criterion, retina_cfg: retina.RetinaConfig, num_fixations: int):
    """``val_classifier`` equivalent: the logits' mean over queries gives
    top-1/top-5 (``DETR_Image_Classification.py:725``). Returns
    ``step(state, images, labels, generator=None, num_fixs=None,
    saccades=None) -> {"loss_ce", "top1", "top5"}``."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None, num_fixs=None,
             saccades: torch.Tensor | None = None) -> dict:
        with span("trainers.eval_step"):
            glimpses, sacc, mask = collect_glimpse_sequence(
                images, retina_cfg, num_fixations, generator, saccades=saccades,
                num_fixs=num_fixs)
            model = state.model
            model.eval()
            with torch.no_grad():
                pred = model(glimpses, sacc, mask)["pred_logits"]
            logits = pred.mean(dim=1)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss_ce": criterion(pred, labels)["loss_ce"],
                                             "top1": top_k_accuracy(logits, labels, 1),
                                             "top5": top_k_accuracy(logits, labels, 5)})

    return step
