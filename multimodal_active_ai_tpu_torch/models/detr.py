"""DETR-style image classifier over saccade sequences.

Port of ``multimodal_active_ai_tpu/models/detr.py`` (reference
``detr_CLA/models/detr.py`` + ``backbone.py``): the SimCLR encoder ``f``,
with ``frozen`` (FrozenBatchNorm, statistics from a pretrained checkpoint)
or ``group`` norms, embeds every glimpse stack of a ``(B, S, 30, 30, 12)``
sequence in one ``(B·S, 30, 30, 12)`` forward; the features, flattened
C-major per saccade, go through ``input_proj`` into the transformer,
positioned by embeddings of the saccade coordinates; ``num_queries``
learned queries come out as per-query class logits.

Variable-length sequences are a static ``S`` plus a ``(B, S)`` pad mask
(True = padded); padded glimpses still go through the backbone. The
backbone has no train mode; only the transformer's dropout follows
``train()``/``eval()``, drawing from the ``generator`` passed to
``forward``. With ``dtype=torch.bfloat16`` the forward runs
under autocast (parameters float32, logits returned float32).

Submodule names give the reference ``state_dict``: ``backbone.0.body.*``
(the encoder), ``backbone.1.{row,col}_embed.weight`` (learned positions),
``transformer.*``, ``input_proj`` (a ``Conv1d`` with kernel 1),
``query_embed``, ``class_embed``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import dense_init_
from multimodal_active_ai_tpu_torch.models.position_encoding import build_position_encoding
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder, encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.transformer import build_transformer
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.utils.profiling import span

BACKBONE_NORMS = ("frozen", "group")


class _Backbone(nn.Module):
    """Holds the encoder as ``body`` (the reference's ``Backbone.body``)."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body


class DETR(nn.Module):
    """DETR classifier (``detr.py:24-70``)."""

    def __init__(self, backbone_arch: str = "ResNet18", num_classes: int = 1000,
                 num_queries: int = 10, hidden_dim: int = 256, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1, pre_norm: bool = False,
                 position_embedding: str = "sine", backbone_norm: str = "frozen",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone_norm not in BACKBONE_NORMS:
            raise ValueError(f"backbone_norm {backbone_norm!r} not in {BACKBONE_NORMS}")
        self.dtype = dtype
        body = build_encoder(backbone_arch, norm_kind=backbone_norm, generator=generator)
        self.backbone = nn.ModuleList([
            _Backbone(body), build_position_encoding(position_embedding, hidden_dim, generator)])
        self.transformer = build_transformer(
            hidden_dim=hidden_dim, dropout=dropout, nheads=nheads,
            dim_feedforward=dim_feedforward, enc_layers=enc_layers,
            dec_layers=dec_layers, pre_norm=pre_norm, generator=generator)
        feat_dim = encoder_feature_dim(backbone_arch) * 16
        # Conv1d(C·16 → hidden, k=1) == a Dense on the feature axis (detr.py:41)
        self.input_proj = nn.Conv1d(feat_dim, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        std = math.sqrt(1.0 / feat_dim) / 0.87962566103423978     # lecun-normal
        with torch.no_grad():
            nn.init.trunc_normal_(self.input_proj.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.input_proj.bias.zero_()
            self.query_embed.weight.normal_(0.0, 1.0, generator=generator)
        dense_init_(self.class_embed, generator)

    @property
    def body(self) -> nn.Module:
        """The encoder ``f``."""
        return self.backbone[0].body

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def features(self, glimpses: torch.Tensor) -> torch.Tensor:
        """Backbone features per saccade, ``(B, S, C·16)`` flattened C-major
        (the ``BackboneBase`` output contract, ``backbone.py:110``)."""
        b, s = glimpses.shape[:2]
        with self._autocast(glimpses):
            feats = self.body(glimpses.reshape((b * s,) + glimpses.shape[2:]))
        return feats.permute(0, 3, 1, 2).reshape(b, s, -1)

    def forward(self, glimpses: torch.Tensor, saccades: torch.Tensor,
                mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """``glimpses`` ``(B, S, g, g, 12)``, ``saccades`` ``(B, S, 2)`` (x, y)
        in [0, 1), ``mask`` ``(B, S)`` bool (True = padded), ``generator``
        the dropout stream (train mode) → ``pred_logits`` ``(B, Q,
        num_classes)`` and ``aux_logits`` ``(dec_layers - 1, B, Q,
        num_classes)``, float32."""
        with self._autocast(glimpses):
            feats = self.features(glimpses)
            with span("models.embed"):
                src = F.linear(feats, self.input_proj.weight[:, :, 0],
                               self.input_proj.bias)                  # (B, S, hidden)
                pos = self.backbone[1](saccades)
            hs, _ = self.transformer(src, mask, self.query_embed.weight, pos, generator)
            with span("models.head"):
                logits = self.class_embed(hs)                         # (L, B, Q, classes)
                return {"pred_logits": logits[-1].float(), "aux_logits": logits[:-1].float()}


def build(cfg, num_classes: int | None = None, dtype: torch.dtype = torch.float32,
          generator: torch.Generator | None = None) -> tuple[DETR, SetCriterion]:
    """``detr.build()`` equivalent (``detr.py:151-178``): ``(model,
    criterion)`` from a ``DETRConfig``; ``num_classes`` defaults per dataset
    (1000 imagenet/synthetic, 90 mscoco)."""
    if num_classes is None:
        num_classes = 1000 if cfg.dataset in ("imagenet", "synthetic") else 90
    model = DETR(backbone_arch=cfg.backbone, num_classes=num_classes,
                 num_queries=cfg.num_queries, hidden_dim=cfg.hidden_dim,
                 nheads=cfg.nheads, enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                 dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
                 pre_norm=cfg.pre_norm, position_embedding=cfg.position_embedding,
                 backbone_norm=cfg.backbone_norm, dtype=dtype, generator=generator)
    return model, SetCriterion(num_queries=cfg.num_queries, num_classes=num_classes)
