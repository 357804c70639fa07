"""Positional encodings over saccade coordinates.

Port of ``multimodal_active_ai_tpu/models/position_encoding.py`` (reference
``detr_CLA/models/position_encoding.py``): the embedding is computed from
each glimpse's fixation coordinates ``(B, S, 2)``, ordered (x, y), not from
a feature-map grid. Sine: coordinates ×100, normalised by their maximum
over the S axis (padded positions included), scaled by 2π, then sin/cos
interleaved; coordinate 0 fills the first half. Learned: an
``Embedding(50, ·)`` lookup per coordinate on ×50-quantised values, keys
``row_embed.weight``/``col_embed.weight`` as in the reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class PositionEmbeddingSine(nn.Module):
    """Sine embedding of saccade coordinates; no parameters."""

    def __init__(self, num_pos_feats: int = 128, temperature: float = 10000.0,
                 normalize: bool = True, scale: float = 2 * math.pi):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale

    def forward(self, saccades: torch.Tensor) -> torch.Tensor:
        """``(B, S, 2)`` in [0, 1) → ``(B, S, 2·num_pos_feats)`` float32."""
        embeds = [saccades[..., 0].float() * 100.0, saccades[..., 1].float() * 100.0]
        if self.normalize:
            embeds = [e / (e.amax(dim=1, keepdim=True) + 1e-6) * self.scale for e in embeds]
        n = self.num_pos_feats
        dim_t = torch.arange(n, dtype=torch.float32, device=saccades.device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / n)

        def interleave(e):
            p = e[..., None] / dim_t
            return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2)

        return torch.cat([interleave(e) for e in embeds], dim=-1)


class PositionEmbeddingLearned(nn.Module):
    """Learned embedding on ×50-quantised coordinates: ``row_embed`` looks
    up coordinate 0, ``col_embed`` coordinate 1; init U[0, 1) (flax's
    ``uniform(1.0)``)."""

    def __init__(self, num_pos_feats: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.row_embed = nn.Embedding(50, num_pos_feats)
        self.col_embed = nn.Embedding(50, num_pos_feats)
        with torch.no_grad():
            for emb in (self.row_embed, self.col_embed):
                emb.weight.uniform_(0.0, 1.0, generator=generator)

    def forward(self, saccades: torch.Tensor) -> torch.Tensor:
        i = (saccades[..., 1] * 50).to(torch.int64).clamp(0, 49)
        j = (saccades[..., 0] * 50).to(torch.int64).clamp(0, 49)
        return torch.cat([self.row_embed(j), self.col_embed(i)], dim=-1)


def build_position_encoding(position_embedding: str, hidden_dim: int,
                            generator: torch.Generator | None = None) -> nn.Module:
    """``build_position_encoding`` (``position_encoding.py:83-93``)."""
    n_steps = hidden_dim // 2
    if position_embedding in ("v2", "sine"):
        return PositionEmbeddingSine(n_steps, normalize=True)
    if position_embedding in ("v3", "learned"):
        return PositionEmbeddingLearned(n_steps, generator)
    raise ValueError(f"not supported {position_embedding}")
