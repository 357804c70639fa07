"""1-D ResNet for signal-domain experiments.

Port of ``multimodal_active_ai_tpu/models/resnet1d.py`` (reference
``SimCLR/ResNet/ResNet1d.py:17-159``): the Conv1d variant of the CIFAR
ResNet with a classification head, avg-pool(16) → flatten →
Linear(1024) → Linear(classes).

The input is ``(B, L, 1)`` as in the JAX package, viewed as ``(B, 1, L)``
inside; the pooled ``(B, C, L')`` map flattens C-major, as the reference's
``out.view(B, -1)`` does (the JAX module flattens ``(B, L', C)`` L-major;
:func:`~multimodal_active_ai_tpu_torch.utils.checkpoint.
from_jax_resnet1d_variables` permutes the first Dense's rows). The first
Linear's width follows the signal ``length`` the model is built for:
``⌊L₃/16⌋·512·expansion`` with ``L₃`` the length after the three stride-2
stages (5000 or 5008 → 39 positions, 19,968 per 512 channels, the
reference's width). Every conv and Linear takes flax's default
initialisation, lecun-normal (fan-in, truncated) with zero biases, not
``conv_init``; the norm comes from ``make_norm`` (``bn`` by default).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import dense_init_
from multimodal_active_ai_tpu_torch.models.norm import make_norm


def _conv1d(cin: int, cout: int, k: int, stride: int = 1,
            generator: torch.Generator | None = None) -> nn.Conv1d:
    """A bias-free conv with flax's default lecun-normal kernel."""
    conv = nn.Conv1d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    std = math.sqrt(1.0 / (cin * k)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return conv


class BasicBlock1d(nn.Module):
    """Two 3-tap convs (the first strided) + residual (``ResNet1d.py:17-41``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv1d(inplanes, planes, 3, stride, generator)
        self.bn1 = norm(planes)
        self.conv2 = _conv1d(planes, planes, 3, generator=generator)
        self.bn2 = norm(planes)
        out = planes * self.expansion
        self.shortcut = (nn.Sequential(_conv1d(inplanes, out, 1, stride, generator), norm(out))
                         if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class Bottleneck1d(nn.Module):
    """1 → 3 (strided) → 1-tap convs + residual (``ResNet1d.py:44-72``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv1d(inplanes, planes, 1, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = _conv1d(planes, planes, 3, stride, generator)
        self.bn2 = norm(planes)
        self.conv3 = _conv1d(planes, out, 1, generator=generator)
        self.bn3 = norm(out)
        self.shortcut = (nn.Sequential(_conv1d(inplanes, out, 1, stride, generator), norm(out))
                         if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + (x if self.shortcut is None else self.shortcut(x)))


def pooled_length(length: int) -> int:
    """Positions after the three stride-2 stages and the avg-pool(16)."""
    for _ in range(3):
        length = (length + 1) // 2
    return length // 16


class ResNet1d(nn.Module):
    """``(B, L, 1)`` → logits ``(B, num_classes)`` (``ResNet1d.py:81-122``)."""

    def __init__(self, block: type = BasicBlock1d, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, length: int = 5000, norm_kind: str = "bn",
                 generator: torch.Generator | None = None):
        super().__init__()
        norm = make_norm(norm_kind)
        self.length = length
        self.conv1 = _conv1d(1, 64, 3, generator=generator)
        self.bn1 = norm(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            mods = []
            for b in range(blocks):
                mods.append(block(inplanes, planes, stride if b == 0 else 1, norm, generator))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
        self.linear1 = nn.Linear(pooled_length(length) * inplanes, 1024)
        self.linear2 = nn.Linear(1024, num_classes)
        dense_init_(self.linear1, generator)
        dense_init_(self.linear2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.length:
            raise ValueError(f"signal of length {x.shape[1]}; this model was built for "
                             f"{self.length}")
        x = x.permute(0, 2, 1)                    # (B, L, 1) memory, (B, 1, L) view
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = F.avg_pool1d(x, 16, 16)
        return self.linear2(self.linear1(x.reshape(x.shape[0], -1)))


def resnet1d_18(**kw) -> ResNet1d:
    return ResNet1d(BasicBlock1d, (2, 2, 2, 2), **kw)


def resnet1d_101(**kw) -> ResNet1d:
    return ResNet1d(Bottleneck1d, (3, 4, 23, 3), **kw)
