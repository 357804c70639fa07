"""Accuracy metrics.

Port of ``multimodal_active_ai_tpu/utils/metrics.py`` (reference
``SimCLR/Model_Util.py:104-113``).
"""

from __future__ import annotations

import torch


def top_k_accuracy(preds: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of rows whose target index is among the top-k predictions.

    ``target`` is a class-index vector ``(N,)`` or a one-hot/soft matrix
    ``(N, C)`` (argmax taken). Ties rank the lower index first, as the
    JAX version's stable argsort does. Returns a float32 device scalar.
    """
    b = target if target.dim() == 1 else torch.argmax(target, dim=1)
    topk = torch.argsort(-preds, dim=1, stable=True)[:, :k]
    correct = (topk == b[:, None]).any(dim=1)
    return correct.to(torch.float32).mean()
