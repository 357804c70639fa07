"""DQN saccade policy network: ResNet trunk + x/y action heads.

Port of ``multimodal_active_ai_tpu/models/qnet.py`` (reference
``DQN/Q_net.py:17-104``): the foveated-ResNet trunk ``f`` of the SimCLR
encoder and two independent heads ``g_x``, ``g_y``, each
``MLP(C·16 → 1024 → num_of_actions)``, scoring quantized fixation
coordinates of the next saccade from one ``(B, 30, 30, 12)`` glimpse stack.
The heads flatten the trunk's ``(B, 4, 4, C)`` output C-major, as the
SimCLR projector does (``utils.checkpoint.from_jax_dqn_variables`` permutes
JAX weights into that order). Train and eval mode are the module's own:
``train()`` moves the BatchNorm running statistics, ``eval()`` reads them.
With ``dtype=torch.bfloat16`` the forward runs under autocast; the Q values
come out float32.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import MLP
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder, encoder_feature_dim


class DQN(nn.Module):
    """``f(x) → (g_x, g_y)`` (reference ``Q_net.py:17-40``)."""

    def __init__(self, arch: str = "ResNet18", num_of_actions: int = 100,
                 norm_kind: str = "bn", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.f = build_encoder(arch, norm_kind=norm_kind, generator=generator)
        feat_dim = encoder_feature_dim(arch) * 16
        # MLP(C·4·4, 1024, A), Q_net.py:73-76
        self.g_x = MLP(feat_dim, 1024, num_of_actions, generator=generator)
        self.g_y = MLP(feat_dim, 1024, num_of_actions, generator=generator)

    def forward(self, glimpses: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, g, g, 12)`` glimpses → ``(q_x, q_y)``, each ``(B, A)`` float32."""
        with torch.autocast(glimpses.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.f(glimpses)
            qx, qy = self.g_x(feats), self.g_y(feats)
        return qx.to(torch.float32), qy.to(torch.float32)


def build_dqn(arch: str = "ResNet18", num_of_actions: int = 100, norm_kind: str = "bn",
              dtype: torch.dtype = torch.float32,
              generator: torch.Generator | None = None) -> DQN:
    """Factory mirroring ``Q_net.build_dqn`` (``Q_net.py:45-104``); the RLS
    driver builds ``norm_kind='bn'`` (``'sync_bn'`` raises until the
    multi-GPU item)."""
    return DQN(arch=arch, num_of_actions=num_of_actions, norm_kind=norm_kind,
               dtype=dtype, generator=generator)
