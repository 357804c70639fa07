"""Image–text contrastive caption probe: the two towers and their steps.

Port of ``multimodal_active_ai_tpu/train/caption_probe.py``. The image tower
is the linear probe's frozen feature extraction
(:func:`~multimodal_active_ai_tpu_torch.train.eval_probe.extract_features`:
one glimpse sampler launch over the ``F·B`` plan, the encoder in eval mode
under ``no_grad``, each fixation's block C-major) followed by a projection
head ``MLP(F·C·16 → 1024 → 128)``; the text tower is a
:class:`~multimodal_active_ai_tpu_torch.models.text.TextEncoder`. The two
are aligned with the symmetric InfoNCE objective, which is NT-Xent with
view 1 = image and view 2 = caption, with every operand differentiable
(``torch_gather_semantics=False``) so that both towers get gradient.

Randomness comes from explicit ``torch.Generator``s: one for the fixations
(tests may hand in ``fix_yx`` ``(F·B, 2)``, view-major instead) and, in the
train step, one for the text tower's dropout (the JAX step's ``dropout``
key).

With several ranks (``parallel/``) the fixations are drawn for the global
batch and each rank keeps its rows; the InfoNCE gathers both towers'
embeddings from every rank with their gradient, so each rank's backward
carries every rank's cotangent of its rows; the gradient is averaged over
the ranks before the update, and the metrics returned are the global
batch's (retrieval over all ``N·B`` pairs). The dropout masks are the
global batch's draws (``models/transformer.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import MLP
from multimodal_active_ai_tpu_torch.models.text import TextEncoder
from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import average_gradients
from multimodal_active_ai_tpu_torch.train.eval_probe import extract_features
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy


class CaptionTowers(nn.Module):
    """The trained half of the probe: ``image_head`` (an ``MLP`` on the
    concatenated frozen features) and ``text`` (a ``TextEncoder``), the
    JAX checkpoint's ``{"image_head", "text"}``."""

    def __init__(self, feat_dim: int, text: TextEncoder, hidden_dim: int = 1024,
                 out_dim: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        self.image_head = MLP(feat_dim, hidden_dim, out_dim, generator=generator)
        self.text = text


def _embeddings(towers: CaptionTowers, encoder: nn.Module, images: torch.Tensor,
                tokens: torch.Tensor, retina_cfg: retina.RetinaConfig, num_fixations: int,
                generator: torch.Generator | None, fix_yx: torch.Tensor | None,
                dropout_generator: torch.Generator | None = None):
    feats = extract_features(encoder, images, retina_cfg, num_fixations, generator, fix_yx)
    return towers.image_head(feats), towers.text(tokens, dropout_generator)


def make_caption_probe_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                                  temperature: float = 0.05):
    """One step: both towers forward (the text tower in train mode, its
    dropout active), symmetric InfoNCE, one optimizer update of the image
    head and the text tower together (the encoder stays frozen). Returns
    ``step(state, encoder, images, tokens, generator=None, fix_yx=None,
    dropout_generator=None) -> {"loss"}`` (a device scalar);
    ``dropout_generator`` draws the text tower's dropout (needed when its
    rate is above 0); ``state.model`` is the :class:`CaptionTowers`."""

    def step(state: TrainState, encoder: nn.Module, images: torch.Tensor,
             tokens: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None,
             dropout_generator: torch.Generator | None = None) -> dict:
        towers, opt = state.model, state.optimizer
        towers.train()
        img, txt = _embeddings(towers, encoder, images, tokens, retina_cfg, num_fixations,
                               generator, fix_yx, dropout_generator)
        loss, _, _ = contrastive_loss(img, txt, temperature=temperature,
                                      torch_gather_semantics=False)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(towers.parameters())
        scheduled_update(state)
        return mean_across_replicas({"loss": loss.detach()})

    return step


def make_caption_probe_eval_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                                 temperature: float = 0.05):
    """Retrieval metrics over the batch: the loss and top-1/top-5 in both
    directions (image → text from the loss's logits, text → image from a
    second loss with the views swapped). Returns ``step(state, encoder,
    images, tokens, generator=None, fix_yx=None) -> {"loss", "i2t_top1",
    "i2t_top5", "t2i_top1", "t2i_top5"}`` (fractions, device scalars)."""

    @torch.no_grad()
    def step(state: TrainState, encoder: nn.Module, images: torch.Tensor,
             tokens: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        towers = state.model
        towers.eval()
        img, txt = _embeddings(towers, encoder, images, tokens, retina_cfg, num_fixations,
                               generator, fix_yx)
        loss, logits_it, labels = contrastive_loss(img, txt, temperature=temperature,
                                                   torch_gather_semantics=False)
        _, logits_ti, _ = contrastive_loss(txt, img, temperature=temperature,
                                           torch_gather_semantics=False)
        return mean_across_replicas({"loss": loss,
                                     "i2t_top1": top_k_accuracy(logits_it, labels, 1),
                                     "i2t_top5": top_k_accuracy(logits_it, labels, 5),
                                     "t2i_top1": top_k_accuracy(logits_ti, labels, 1),
                                     "t2i_top5": top_k_accuracy(logits_ti, labels, 5)})

    return step
