"""SimCLR NT-Xent contrastive objective (single process).

Port of ``multimodal_active_ai_tpu/objectives/ntxent.py`` for
``axis_name=None``: L2-normalise, aa/bb/ab/ba logit blocks with a
``-LARGE_NUM`` self-mask, soft cross-entropy summed over both directions
(reference ``SimCLR/Objective.py:17-125``).

``torch_gather_semantics=True`` (the default) detaches both "gathered"
operands, reproducing the gradient of the reference's N-rank run, where
``dist.all_gather`` is not differentiable: ``logits_bb = h2 @ h2.detach().T``,
``logits_ab = h1 @ h2.detach().T``, ``logits_ba = h2 @ h1.detach().T``.
``False`` makes every operand differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LARGE_NUM = 1e9


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(‖x‖, eps)`` row-wise (torch ``F.normalize`` semantics)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def _softmax_cross_entropy(targets: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Soft cross-entropy, mean over rows (``Objective.py:123-125``)."""
    return -torch.sum(targets * F.log_softmax(logits, dim=1)) / logits.shape[0]


def contrastive_loss(hidden1: torch.Tensor, hidden2: torch.Tensor,
                     hidden_norm: bool = True, temperature: float = 1.0,
                     torch_gather_semantics: bool = True):
    """NT-Xent between two views ``(B, D)``; returns ``(loss, logits_ab,
    labels)`` with ``logits_ab`` ``(B, B)`` and one-hot ``labels``
    ``(B, 2B)``. The caller detaches ``hidden1`` where the reference does
    (the SimCLR step passes the previous view detached)."""
    hidden1 = hidden1.to(torch.float32)
    hidden2 = hidden2.to(torch.float32)
    if hidden_norm:
        hidden1 = _l2_normalize(hidden1)
        hidden2 = _l2_normalize(hidden2)
    batch_size = hidden1.shape[0]
    gather = torch.Tensor.detach if torch_gather_semantics else (lambda x: x)
    hidden1_large = gather(hidden1)
    hidden2_large = gather(hidden2)
    idx = torch.arange(batch_size, device=hidden1.device)
    labels = F.one_hot(idx, batch_size * 2).to(torch.float32)
    masks = F.one_hot(idx, batch_size).to(torch.float32)

    def sim(a, b):
        return (a @ b.T) / temperature

    logits_aa = sim(hidden1, hidden1_large) - masks * LARGE_NUM
    logits_bb = sim(hidden2, hidden2_large) - masks * LARGE_NUM
    logits_ab = sim(hidden1, hidden2_large)
    logits_ba = sim(hidden2, hidden1_large)

    loss_a = _softmax_cross_entropy(labels, torch.cat([logits_ab, logits_aa], 1))
    loss_b = _softmax_cross_entropy(labels, torch.cat([logits_ba, logits_bb], 1))
    return loss_a + loss_b, logits_ab, labels
