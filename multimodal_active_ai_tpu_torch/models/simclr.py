"""SimCLR module: encoder ``f`` + projector ``g``.

Port of ``multimodal_active_ai_tpu/models/simclr.py``: ``g(f(glimpses))``
on ``(B, 30, 30, 12)`` NHWC glimpse stacks, output cast to float32. With
``dtype=torch.bfloat16`` the forward runs under autocast: convolutions and
products in bf16, parameters and BatchNorm statistics in float32.
``stat_fusion`` (``'pallas'``/``'gram'``) fuses the Bottleneck 1×1 convs'
BatchNorm statistics into the convs (``models/conv_bn.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import MLP
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder, encoder_feature_dim
from multimodal_active_ai_tpu_torch.utils.profiling import span


class SimCLRModule(nn.Module):
    """``g(f(x))`` with submodules named ``f``/``g``, the reference
    checkpoint layout (downstream consumers keep ``f``)."""

    def __init__(self, arch: str = "ResNet18", projection_hidden: int = 1024,
                 projection_dim: int = 128, norm_kind: str = "bn",
                 dtype: torch.dtype = torch.float32,
                 stat_fusion: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.f = build_encoder(arch, norm_kind=norm_kind, stat_fusion=stat_fusion,
                               generator=generator)
        self.g = MLP(encoder_feature_dim(arch) * 16, projection_hidden,
                     projection_dim, generator=generator)

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def forward(self, glimpses: torch.Tensor) -> torch.Tensor:
        with self._autocast(glimpses):
            feats = self.f(glimpses)
            with span("models.projector"):
                return self.g(feats).to(torch.float32)

    def features(self, glimpses: torch.Tensor) -> torch.Tensor:
        """Encoder features only, ``(B, 4, 4, C)`` NHWC (the downstream
        contract); train/eval mode is the module's own."""
        with self._autocast(glimpses):
            return self.f(glimpses)
