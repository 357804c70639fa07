"""Legacy CIFAR-style foveated ResNet (15-channel input, 3×3 stem).

Port of ``multimodal_active_ai_tpu/models/resnet_legacy.py`` (reference
``SimCLR/ResNet/ResNet.py:17-146``): the earlier 5-crop / 15-channel encoder
generation, with a 3×3 stride-1 stem, no pooling anywhere, CIFAR-style
blocks (the stride on the block's first conv, a 1×1 shortcut) and the
spatial map out. Bottlenecks stride on the 3×3.

As in :mod:`~multimodal_active_ai_tpu_torch.models.resnet`, the public
layout is NHWC (``(B, H, W, 3·crop_measures)`` in, ``(B, H', W',
512·expansion)`` out) and the convolutions run on the NCHW view; convs take
``conv_init`` (kaiming-normal, fan-out, truncated) and the norm comes from
:func:`~multimodal_active_ai_tpu_torch.models.norm.make_norm`
(``sync_bn`` by default, the JAX default; ``bn`` on one process).
Submodule names are torchvision's (``conv1``, ``bn1``, ``layer{s}.{i}.
conv{k}``/``bn{k}``, ``shortcut.0``/``.1``); weights cross from JAX with
:func:`~multimodal_active_ai_tpu_torch.utils.checkpoint.
from_jax_legacy_resnet_variables`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.norm import make_norm
from multimodal_active_ai_tpu_torch.models.resnet import _conv


class LegacyBasicBlock(nn.Module):
    """Two 3×3 convs (the first strided) + residual (``ResNet.py:17-41``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, generator=generator)
        self.bn2 = norm(planes)
        out = planes * self.expansion
        self.shortcut = (nn.Sequential(_conv(inplanes, out, 1, stride, generator=generator),
                                       norm(out))
                         if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class LegacyBottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 + residual (``ResNet.py:44-72``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, generator=generator)
        self.bn2 = norm(planes)
        self.conv3 = _conv(planes, out, 1, generator=generator)
        self.bn3 = norm(out)
        self.shortcut = (nn.Sequential(_conv(inplanes, out, 1, stride, generator=generator),
                                       norm(out))
                         if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class LegacyResNet(nn.Module):
    """The 15-channel (3·5-crop) trunk, no pooling: spatial map out
    (``ResNet.py:92-124``)."""

    def __init__(self, block: type = LegacyBasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 crop_measures: int = 5, norm_kind: str = "sync_bn",
                 generator: torch.Generator | None = None):
        super().__init__()
        norm = make_norm(norm_kind)
        self.conv1 = _conv(3 * crop_measures, 64, 3, generator=generator)
        self.bn1 = norm(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            mods = []
            for b in range(blocks):
                mods.append(block(inplanes, planes, stride if b == 0 else 1, norm, generator))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3·crop_measures)`` NHWC → ``(B, ⌈H/8⌉, ⌈W/8⌉,
        512·expansion)`` NHWC."""
        x = x.permute(0, 3, 1, 2)                 # NHWC memory, NCHW view
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.permute(0, 2, 3, 1)


def legacy_resnet18(**kw) -> LegacyResNet:
    return LegacyResNet(LegacyBasicBlock, (2, 2, 2, 2), **kw)


def legacy_resnet34(**kw) -> LegacyResNet:
    return LegacyResNet(LegacyBasicBlock, (3, 4, 6, 3), **kw)


def legacy_resnet50(**kw) -> LegacyResNet:
    return LegacyResNet(LegacyBottleneck, (3, 4, 6, 3), **kw)


def legacy_resnet101(**kw) -> LegacyResNet:
    return LegacyResNet(LegacyBottleneck, (3, 4, 23, 3), **kw)


def legacy_resnet152(**kw) -> LegacyResNet:
    return LegacyResNet(LegacyBottleneck, (3, 8, 36, 3), **kw)
