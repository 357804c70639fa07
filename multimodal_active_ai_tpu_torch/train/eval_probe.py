"""Linear-probe evaluation: frozen encoder features and the probe's steps.

Port of ``multimodal_active_ai_tpu/train/eval_probe.py`` (reference
``Representation_Evaluation.py:598-833``). A step builds the mip pyramid
once, samples all ``F`` labeled fixations of the batch in one
``apply_retina_views`` call over the view-major ``F·B`` plan (one glimpse
sampler launch), runs one ``F·B`` encoder forward in eval mode under
``no_grad`` (the ``fused`` and ``canvas`` retinas: one retina call and
one ``B``-row forward a fixation, as in the JAX package), and
concatenates each image's ``F`` feature maps into the probe input
``(B, F·C·16)``. Each fixation's block is flattened C-major, the
reference's order (``Representation_Evaluation.py:430-433``); the JAX
package flattens NHWC, so weights carried across are permuted per block
(``utils.checkpoint.from_jax_probe_variables``).

Randomness comes from an explicit ``torch.Generator``; tests may hand in the
fixations ``fix_yx`` ``(F·B, 2)`` ``(y, x)``, view-major, instead.

With several ranks (``parallel/``) the fixations are drawn for the global
batch and each rank keeps its rows, the probe's gradient is averaged over
the ranks before its update, and the returned metrics are the global
batch's. The encoder is frozen, in eval mode: no statistics cross ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import average_gradients, local_rows, world_size
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy
from multimodal_active_ai_tpu_torch.utils.profiling import span


@torch.no_grad()
def extract_features(encoder: torch.nn.Module, images: torch.Tensor,
                     retina_cfg: retina.RetinaConfig, num_fixations: int,
                     generator: torch.Generator | None = None,
                     fix_yx: torch.Tensor | None = None) -> torch.Tensor:
    """Concatenated frozen features of ``num_fixations`` labeled glimpses
    per image: ``(B, F·C·16)`` float32, fixation-major, each block C-major.

    ``encoder`` has ``features(glimpses) -> (N, 4, 4, C)`` (a
    :class:`~multimodal_active_ai_tpu_torch.models.simclr.SimCLRModule`); it
    is put in eval mode, so its BatchNorms use their running statistics.
    """
    batch, src = images.shape[0], images.shape[1]
    if fix_yx is None:
        # the global batch's view-major draws, this rank's rows of each view
        with span("retina.draw"):
            glob = torch.rand((num_fixations, batch * world_size(), 2), generator=generator,
                              device=generator.device)
            fix_yx = local_rows(glob, 1).reshape(num_fixations * batch, 2)
    params = retina.sample_labeled_params(None, num_fixations * batch, src, fix_yx)
    encoder.eval()
    if retina_cfg.mode == "matmul":
        pyramid = retina.build_pyramid(images, retina_cfg)
        glimpses = retina.apply_retina_views(pyramid, params, retina_cfg, photometric=False)
        feats = encoder.features(glimpses)                      # (F·B, 4, 4, C)
    else:
        # fused/canvas: one retina call and one B-row forward a fixation
        feats = torch.cat([encoder.features(retina.apply_retina(
            images, retina.AugParams(*(f[j * batch:(j + 1) * batch] for f in params)),
            retina_cfg, photometric=False)) for j in range(num_fixations)])
    feats = feats.permute(0, 3, 1, 2).reshape(num_fixations, batch, -1)
    return feats.transpose(0, 1).reshape(batch, -1).to(torch.float32)


def make_probe_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int):
    """``train_classifier`` equivalent. Returns ``step(state, encoder,
    images, labels, generator=None, fix_yx=None) -> {"loss"}`` (a device
    scalar); ``state.model`` is the probe, and ``state.step`` advances by
    one update with the scheduled learning rate."""

    def step(state: TrainState, encoder: torch.nn.Module, images: torch.Tensor,
             labels: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        with span("trainers.step", state.step):
            feats = extract_features(encoder, images, retina_cfg, num_fixations,
                                     generator, fix_yx)
            probe, opt = state.model, state.optimizer
            probe.train()
            logits = probe(feats)
            with span("trainers.loss"):
                loss = F.cross_entropy(logits, labels)
            with span("trainers.backward"):
                opt.zero_grad(set_to_none=True)
                loss.backward()
            with span("trainers.update"):
                average_gradients(probe.parameters())
                scheduled_update(state)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss": loss.detach()})

    return step


def make_probe_eval_step(retina_cfg: retina.RetinaConfig, num_fixations: int):
    """``val_classifier`` equivalent: ``step(state, encoder, images, labels,
    generator=None, fix_yx=None) -> {"loss", "top1", "top5"}`` (fractions,
    device scalars)."""

    def step(state: TrainState, encoder: torch.nn.Module, images: torch.Tensor,
             labels: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        with span("trainers.eval_step"):
            feats = extract_features(encoder, images, retina_cfg, num_fixations,
                                     generator, fix_yx)
            probe = state.model
            probe.eval()
            with torch.no_grad():
                logits = probe(feats)
            with span("trainers.loss"):
                loss = F.cross_entropy(logits, labels)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss": loss,
                                             "top1": top_k_accuracy(logits, labels, 1),
                                             "top5": top_k_accuracy(logits, labels, 5)})

    return step
