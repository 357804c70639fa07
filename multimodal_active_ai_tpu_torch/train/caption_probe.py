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

Randomness comes from an explicit ``torch.Generator`` (the fixations) and
torch's own generator (the text tower's dropout); tests may hand in the
fixations ``fix_yx`` ``(F·B, 2)``, view-major.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import MLP
from multimodal_active_ai_tpu_torch.models.text import TextEncoder
from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train.eval_probe import extract_features
from multimodal_active_ai_tpu_torch.train.optimizers import set_learning_rate
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
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
                generator: torch.Generator | None, fix_yx: torch.Tensor | None):
    feats = extract_features(encoder, images, retina_cfg, num_fixations, generator, fix_yx)
    return towers.image_head(feats), towers.text(tokens)


def make_caption_probe_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                                  temperature: float = 0.05):
    """One step: both towers forward (the text tower in train mode, its
    dropout active), symmetric InfoNCE, one optimizer update of the image
    head and the text tower together (the encoder stays frozen). Returns
    ``step(state, encoder, images, tokens, generator=None, fix_yx=None) ->
    {"loss"}`` (a device scalar); ``state.model`` is the
    :class:`CaptionTowers`."""

    def step(state: TrainState, encoder: nn.Module, images: torch.Tensor,
             tokens: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        towers, opt = state.model, state.optimizer
        towers.train()
        img, txt = _embeddings(towers, encoder, images, tokens, retina_cfg, num_fixations,
                               generator, fix_yx)
        loss, _, _ = contrastive_loss(img, txt, temperature=temperature,
                                      torch_gather_semantics=False)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        set_learning_rate(opt, state.schedule(state.step))
        opt.step()
        state.step += 1
        return {"loss": loss.detach()}

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
        return {"loss": loss,
                "i2t_top1": top_k_accuracy(logits_it, labels, 1),
                "i2t_top5": top_k_accuracy(logits_it, labels, 5),
                "t2i_top1": top_k_accuracy(logits_ti, labels, 1),
                "t2i_top5": top_k_accuracy(logits_ti, labels, 5)}

    return step
