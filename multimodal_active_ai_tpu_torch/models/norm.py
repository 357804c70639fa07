"""BatchNorm with flax semantics.

Port of the ``bn`` and ``bn_fused`` kinds of
``multimodal_active_ai_tpu/models/norm.py``
(``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` and
``FusedStatsBatchNorm``). They differ from
``torch.nn.BatchNorm2d`` where eval-mode outputs would otherwise diverge:

* batch statistics are taken in float32 whatever the input dtype, with the
  one-pass ("fast") variance ``E[x²] - E[x]²`` clipped at 0;
* the running update is ``r ← 0.9·r + 0.1·batch`` with the **biased**
  batch variance (``BatchNorm2d`` uses the unbiased one);
* the output is ``(x - mean)·rsqrt(var + ε)·weight + bias``, computed in
  float32 and cast back to the input dtype.

The buffers keep torch's names (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so ``state_dict`` keys are those
of the reference torch checkpoints, and the two kinds' ``state_dict``s are
interchangeable.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.ops.stat_sums import batch_mean_var


class BatchNorm(nn.Module):
    """Flax-semantics BatchNorm over the channel dim 1 of an NCHW input."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum  # flax convention: weight of the old value
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return self.normalize(x.movedim(1, -1), mean, var, x.dtype).movedim(-1, 1)

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Float32 ``(mean, var)`` of ``x`` over all but the channel dim 1."""
        xf = x.to(torch.float32)
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dim=dims)
        return mean, torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``r ← momentum·r + (1 - momentum)·batch`` for the batch's
        ``mean`` and biased ``var``."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)
        self.num_batches_tracked.add_(1)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """``(x - mean)·rsqrt(var + ε)·weight + bias`` in float32, cast to
        ``dtype``, for ``x`` with the channels on its last axis."""
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.to(torch.float32) - mean) * mul + self.bias).to(dtype)


class FusedStatsBatchNorm(BatchNorm):
    """:class:`BatchNorm` whose batch statistics come from one
    :func:`~multimodal_active_ai_tpu_torch.ops.stat_sums.batch_mean_var`
    pass (the ``stat_sums`` kernel on CUDA) instead of two ``.mean()``
    reductions. Same parameters, buffers and arithmetic.

    The input is viewed channels-last as ``(N·H·W, C)``: free for the
    port's ``channels_last`` activations on CUDA, a copy otherwise.
    """

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return batch_mean_var(x.movedim(1, -1))


def make_norm(kind: str):
    """Norm-layer factory, the analogue of the reference's ``norm_layer``.
    ``'bn'`` and ``'bn_fused'`` are ported; the other kinds raise."""
    if kind == "bn":
        return BatchNorm
    if kind == "bn_fused":
        return FusedStatsBatchNorm
    raise NotImplementedError(
        f"norm kind {kind!r} is not ported yet (ROADMAP: sync_bn with the "
        "multi-GPU item, frozen/group with the DETR slice); use 'bn' or 'bn_fused'")
