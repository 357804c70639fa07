"""Foveated ResNet encoder family.

Port of ``multimodal_active_ai_tpu/models/resnet.py``: torchvision-style
ResNet with the retina surgery of the reference ``SimCLR/ResNet/resnet.py``
— ``conv1`` takes ``3·crop_measures`` (= 12) channels at **stride 1**, no
stem max-pool, no final pool or fc — so a ``(B, 30, 30, 12)`` glimpse stack
gives a ``(B, 4, 4, 512·expansion)`` feature map (30 → 30 → 15 → 8 → 4).
Bottlenecks stride on the 3×3 (v1.5).

Public layouts are NHWC like the JAX package; inside, the convolutions run
on the NCHW view of the same memory (``channels_last``), so the permutes
at the edges copy nothing. Submodule names follow the reference torch
layout (``conv1``, ``bn1``, ``layer{s}.{i}.conv{k}``/``bn{k}``,
``downsample.0``/``.1``), so ``state_dict`` is the reference
``.pth.tar`` layout.

Every conv and its norm run through :func:`~multimodal_active_ai_tpu_torch.
models.norm.conv_norm_act` with the residual add and ReLU that follow: on
the card a train-mode ``bn`` or ``sync_bn`` is then the fused kernels of
``ops/bn_act.py``.

``stat_fusion='pallas'|'gram'`` makes each Bottleneck produce its 1×1
convs' BatchNorm statistics with the convs themselves
(:func:`~multimodal_active_ai_tpu_torch.models.conv_bn.conv1x1_bn`, reading
the same ``conv``/``bn`` modules, so the ``state_dict`` is unchanged); the
3×3 conv keeps the injected norm layer and BasicBlocks ignore the option.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.conv_bn import IMPLS, conv1x1_bn
from multimodal_active_ai_tpu_torch.models.norm import conv_norm_act, make_norm
from multimodal_active_ai_tpu_torch.utils.profiling import span

# variance_scaling(2, fan_out, truncated_normal): flax's stddev correction
# for a normal truncated at ±2σ (the JAX package's conv_init)
_TRUNC_STD = 0.87962566103423978


def conv_init_(weight: torch.Tensor, generator: torch.Generator | None = None) -> None:
    """In-place kaiming-normal (fan_out, truncated at ±2σ) of an OIHW
    conv weight, the JAX package's ``conv_init``."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          generator: torch.Generator | None = None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)
    conv_init_(conv.weight, generator)
    return conv


class BasicBlock(nn.Module):
    """Two 3×3 convs + residual (reference ``resnet.py:31-77``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm=None, groups: int = 1,
                 base_width: int = 64, stat_fusion: str | None = None,
                 generator=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, generator=generator)
        self.bn2 = norm(planes)
        self.downsample = (nn.Sequential(
            _conv(inplanes, planes * self.expansion, 1, stride, generator=generator),
            norm(planes * self.expansion)) if downsample else None)

    def forward(self, x):
        identity = (x if self.downsample is None
                    else conv_norm_act(*self.downsample, x, relu=False))
        out = conv_norm_act(self.conv1, self.bn1, x)
        return conv_norm_act(self.conv2, self.bn2, out, identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3(stride) → 1×1 bottleneck, v1.5 placement (reference
    ``resnet.py:80-135``). With ``stat_fusion`` the three 1×1 conv + norm
    pairs run as :func:`conv1x1_bn`."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm=None, groups: int = 1,
                 base_width: int = 64, stat_fusion: str | None = None,
                 generator=None):
        super().__init__()
        self.stat_fusion = stat_fusion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1, generator=generator)
        self.bn1 = norm(width)
        self.conv2 = _conv(width, width, 3, stride, groups, generator=generator)
        self.bn2 = norm(width)
        self.conv3 = _conv(width, planes * self.expansion, 1, generator=generator)
        self.bn3 = norm(planes * self.expansion)
        self.downsample = (nn.Sequential(
            _conv(inplanes, planes * self.expansion, 1, stride, generator=generator),
            norm(planes * self.expansion)) if downsample else None)

    def forward(self, x):
        fusion = self.stat_fusion
        if not fusion:
            identity = (x if self.downsample is None
                        else conv_norm_act(*self.downsample, x, relu=False))
            out = conv_norm_act(self.conv1, self.bn1, x)
            out = conv_norm_act(self.conv2, self.bn2, out)
            return conv_norm_act(self.conv3, self.bn3, out, identity)
        identity = x if self.downsample is None else conv1x1_bn(x, *self.downsample, fusion)
        out = torch.relu(conv1x1_bn(x, self.conv1, self.bn1, fusion))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = conv1x1_bn(out, self.conv3, self.bn3, fusion)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Foveated ResNet trunk: NHWC ``(B, 30, 30, 12)`` in,
    ``(B, 4, 4, 512·expansion)`` NHWC out."""

    def __init__(self, block: type = BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 groups: int = 1, width_per_group: int = 64,
                 crop_measures: int = 4, norm_kind: str = "bn",
                 stat_fusion: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if stat_fusion and norm_kind not in ("bn", "sync_bn", "bn_fused"):
            raise ValueError(f"stat_fusion embeds BatchNorm semantics; incompatible "
                             f"with norm_kind={norm_kind!r}")
        if stat_fusion and stat_fusion not in IMPLS:
            raise ValueError(f"stat_fusion {stat_fusion!r} not in {IMPLS}")
        norm = make_norm(norm_kind)
        self.conv1 = _conv(3 * crop_measures, 64, 7, generator=generator)
        self.bn1 = norm(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                needs_down = s != 1 or inplanes != planes * block.expansion
                mods.append(block(inplanes, planes, s, needs_down, norm, groups,
                                  width_per_group, stat_fusion=stat_fusion or None,
                                  generator=generator))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("models.encoder"):
            x = x.permute(0, 3, 1, 2)             # NHWC memory, NCHW view
            with span("models.encoder.stem"):
                x = conv_norm_act(self.conv1, self.bn1, x)
            for stage, name in _STAGES:
                with span(name):
                    x = getattr(self, stage)(x)
            return x.permute(0, 2, 3, 1)


# the stages and the names of their spans (``utils/profiling.span``)
_STAGES = tuple((f"layer{i}", f"models.encoder.layer{i}") for i in range(1, 5))


_ARCHS = {
    "ResNet10": (BasicBlock, (1, 1, 1, 1), 512),
    "ResNet18": (BasicBlock, (2, 2, 2, 2), 512),
    "ResNet34": (BasicBlock, (3, 4, 6, 3), 512),
    "ResNet50": (Bottleneck, (3, 4, 6, 3), 2048),
    "ResNet101": (Bottleneck, (3, 4, 23, 3), 2048),
    "ResNet152": (Bottleneck, (3, 8, 36, 3), 2048),
}


def encoder_feature_dim(arch: str) -> int:
    """Channels of the encoder output (512 for R10/18/34, 2048 for R50+)."""
    return _ARCHS[arch][2]


def build_encoder(arch: str, **kwargs) -> ResNet:
    """Build the encoder by driver architecture name."""
    if arch not in _ARCHS:
        raise ValueError(f"error: Unrecognized {arch} architecture")
    block, layers, _ = _ARCHS[arch]
    return ResNet(block=block, layers=layers, **kwargs)
