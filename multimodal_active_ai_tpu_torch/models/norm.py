"""BatchNorm with flax semantics.

Port of the ``bn`` kind of ``multimodal_active_ai_tpu/models/norm.py``
(``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``). It differs from
``torch.nn.BatchNorm2d`` where eval-mode outputs would otherwise diverge:

* batch statistics are taken in float32 whatever the input dtype, with the
  one-pass ("fast") variance ``E[x²] - E[x]²`` clipped at 0;
* the running update is ``r ← 0.9·r + 0.1·batch`` with the **biased**
  batch variance (``BatchNorm2d`` uses the unbiased one);
* the output is ``(x - mean)·rsqrt(var + ε)·weight + bias``, computed in
  float32 and cast back to the input dtype.

The buffers keep torch's names (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so ``state_dict`` keys are those
of the reference torch checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn


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
        xf = x.to(torch.float32)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean = xf.mean(dim=dims)
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def make_norm(kind: str):
    """Norm-layer factory, the analogue of the reference's ``norm_layer``.
    Only ``'bn'`` is ported; the other kinds raise."""
    if kind == "bn":
        return BatchNorm
    raise NotImplementedError(
        f"norm kind {kind!r} is not ported yet (ROADMAP: sync_bn with the "
        "multi-GPU item, frozen/group with the DETR slice); use 'bn'")
