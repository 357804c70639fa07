"""DETR classification criterion over saccade sequences.

Port of ``multimodal_active_ai_tpu/objectives/set_criterion.py`` (reference
``detr_CLA/models/detr.py:73-148``): identity matching, so every query is
supervised with the image label, and only the cross-entropy term is kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy


@dataclass(frozen=True)
class SetCriterion:
    """Identity-matching classification criterion."""

    num_queries: int
    num_classes: int

    def __call__(self, pred_logits: torch.Tensor, labels: torch.Tensor) -> dict:
        """``pred_logits`` ``(B, Q, num_classes)`` and ``labels`` ``(B,)`` →
        ``loss_ce`` (mean cross-entropy over B×Q) and ``class_error``
        (100 − top-1 accuracy in %, over B×Q), device scalars."""
        b, q, c = pred_logits.shape
        flat_logits = pred_logits.reshape(b * q, c).float()
        flat_targets = labels[:, None].expand(b, q).reshape(b * q)
        loss_ce = F.cross_entropy(flat_logits, flat_targets)
        class_error = 100.0 - top_k_accuracy(flat_logits.detach(), flat_targets, 1) * 100.0
        return {"loss_ce": loss_ce, "class_error": class_error}
