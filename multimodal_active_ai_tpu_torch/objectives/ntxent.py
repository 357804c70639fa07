"""SimCLR NT-Xent contrastive objective, over every rank's rows.

Port of ``multimodal_active_ai_tpu/objectives/ntxent.py``: L2-normalise,
aa/bb/ab/ba logit blocks with a ``-LARGE_NUM`` self-mask, soft
cross-entropy summed over both directions (reference
``SimCLR/Objective.py:17-125``). On one process it is the ``axis_name=None``
branch; with a process group of N ranks it is the ``axis_name`` branch
(``ntxent.py:85-97``): both views are gathered from every rank, the labels
are offset by ``rank·b`` and ``logits_ab`` is ``(b, N·b)``, so its top-k is
the global retrieval. Each rank's loss is the mean over its own rows; the
mean over ranks is the JAX loss of the global batch.

``torch_gather_semantics=True`` (the default) detaches both gathered
operands, reproducing the gradient of the reference's N-rank run, where
``dist.all_gather`` is not differentiable: ``logits_bb = h2 @ h2.detach().T``,
``logits_ab = h1 @ h2.detach().T``, ``logits_ba = h2 @ h1.detach().T``.
``False`` makes every operand differentiable, the gathered ones through
:func:`~multimodal_active_ai_tpu_torch.parallel.all_gather_with_grad`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_active_ai_tpu_torch.parallel import all_gather_with_grad, cross_replica_concat, rank
from multimodal_active_ai_tpu_torch.utils.profiling import span

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
    """NT-Xent between two views ``(B, D)`` of this rank's rows; returns
    ``(loss, logits_ab, labels)`` with ``logits_ab`` ``(B, N·B)`` and
    one-hot ``labels`` ``(B, 2N·B)`` for N ranks. The caller detaches
    ``hidden1`` where the reference does (the SimCLR step passes the
    previous view detached)."""
    with span("trainers.loss"):
        hidden1 = hidden1.to(torch.float32)
        hidden2 = hidden2.to(torch.float32)
        if hidden_norm:
            hidden1 = _l2_normalize(hidden1)
            hidden2 = _l2_normalize(hidden2)
        batch_size = hidden1.shape[0]
        if torch_gather_semantics:
            def gather(x):
                return cross_replica_concat(x, differentiable_local=False)
        else:
            gather = all_gather_with_grad
        hidden1_large = gather(hidden1)
        hidden2_large = gather(hidden2)
        enlarged = hidden1_large.shape[0]
        idx = torch.arange(batch_size, device=hidden1.device) + rank() * batch_size
        labels = F.one_hot(idx, enlarged * 2).to(torch.float32)
        masks = F.one_hot(idx, enlarged).to(torch.float32)

        def sim(a, b):
            return (a @ b.T) / temperature

        logits_aa = sim(hidden1, hidden1_large) - masks * LARGE_NUM
        logits_bb = sim(hidden2, hidden2_large) - masks * LARGE_NUM
        logits_ab = sim(hidden1, hidden2_large)
        logits_ba = sim(hidden2, hidden1_large)

        loss_a = _softmax_cross_entropy(labels, torch.cat([logits_ab, logits_aa], 1))
        loss_b = _softmax_cross_entropy(labels, torch.cat([logits_ba, logits_bb], 1))
        return loss_a + loss_b, logits_ab, labels


def naive_ntxent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float) -> torch.Tensor:
    """O(N²) per-pair NT-Xent following SimCLR's Algorithm 1 literally: the
    test oracle of the JAX package (``objectives/ntxent.py:122-146``),
    mirroring the reference's module-level loss (``SimCLR/SimCLR.py:
    36-144``) with the paper's ``Sum / (2N)`` normalisation. The views are
    interleaved as the reference does (``z[2k] = z2[k]``, ``z[2k+1] =
    z1[k]``); returns the mean per-view loss, one process's rows only."""
    n = z1.shape[0]
    z = torch.stack([_l2_normalize(z2.float()), _l2_normalize(z1.float())], 1).reshape(2 * n, -1)
    s = z @ z.T

    def pair(i, j):
        row = torch.exp(s[i] / temperature)
        denom = row.sum() - torch.exp(s[i, i] / temperature)
        return -torch.log(torch.exp(s[i, j] / temperature) / denom)

    total = sum(pair(2 * k + 1, 2 * k) + pair(2 * k, 2 * k + 1) for k in range(n))
    return total / (2 * n)
