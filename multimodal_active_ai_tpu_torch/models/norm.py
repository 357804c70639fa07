"""Norm layers with flax semantics.

Port of the ``bn``, ``bn_fused``, ``frozen`` and ``group`` kinds of
``multimodal_active_ai_tpu/models/norm.py``. ``bn`` and ``bn_fused``
(``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` and
``FusedStatsBatchNorm``) differ from
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

``frozen`` (:class:`FrozenBatchNorm`, the DETR backbone's) holds all four
tensors as buffers, as the reference's ``FrozenBatchNorm2d`` does, and
``group`` (:class:`GroupNormAdapter`) is flax's ``GroupNorm`` (ε = 1e-6,
float32 statistics); neither has a train mode.
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


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (the JAX
    package's ``FrozenBatchNorm``, reference ``backbone.py:35-70``).

    ``scale = weight / sqrt(var + ε)`` and ``shift = bias - mean·scale`` are
    taken in float32, then ``x·scale + shift`` in the input's dtype (bf16
    under the drivers' autocast), as the JAX module applies them in its
    dtype. The four tensors are buffers, so no optimizer sees them, and
    there is no ``num_batches_tracked``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class GroupNormAdapter(nn.Module):
    """flax ``GroupNorm`` over the channel dim 1: ``num_groups`` = the
    largest divisor of the channel count that is at most 32, float32
    statistics, ε = 1e-6 (flax's default, not torch's 1e-5), output in the
    input's dtype. Parameters ``weight``/``bias``."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        groups = min(num_groups, num_features)
        while num_features % groups:
            groups -= 1
        self.num_groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.group_norm(x.to(torch.float32), self.num_groups,
                                     self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def make_norm(kind: str):
    """Norm-layer factory, the analogue of the reference's ``norm_layer``:
    ``'bn'``, ``'bn_fused'``, ``'frozen'`` or ``'group'``; ``'sync_bn'``
    raises until the multi-GPU item."""
    kinds = {"bn": BatchNorm, "bn_fused": FusedStatsBatchNorm,
             "frozen": FrozenBatchNorm, "group": GroupNormAdapter}
    if kind in kinds:
        return kinds[kind]
    if kind == "sync_bn":
        raise NotImplementedError(
            "norm kind 'sync_bn' is not ported yet (ROADMAP: multi-GPU, "
            "DDP/SyncBN); use 'bn'")
    raise ValueError(f"unknown norm kind {kind!r}")
