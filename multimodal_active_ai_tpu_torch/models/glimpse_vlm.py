"""A generative captioner over glimpses: a Kimi-VL-style projector from the
frozen encoder's glimpse maps into a language model's sequence.

The vision tower is the system's own: each glimpse's ``(4, 4, C)`` map of
the frozen foveated encoder (``train/eval_probe.frozen_feature_maps``). The
projector follows Kimi-VL's layout for MoonViT's patches: LayerNorm(C)
(ε 1e-5) on each position, a 2×2 merge into ``4`` tokens of ``4C`` (row-
major over the merged 2×2 grid, each token the 2×2 block's positions in
row-major order, channels last), ``Linear(4C → 4C)``, GELU (erf),
``Linear(4C → d)``. The sequence is each image's ``F·4`` image tokens, in
fixation order, then the caption's ``Lt`` token embeddings; positions
``0 … F·4 + Lt − 1``. Teacher forcing: the caption's token ``t`` is
predicted at the position before it, so the head reads positions
``F·4 − 1 … F·4 + Lt − 2``.

With ``dtype`` bf16 the forward runs under autocast (parameters float32,
logits float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.models.mla import RMSNorm
from multimodal_active_ai_tpu_torch.models.moe import HeldExperts, Router
from multimodal_active_ai_tpu_torch.models.moe_lm import MoELM, MoELMConfig
from multimodal_active_ai_tpu_torch.utils.profiling import span

MERGE = 2


class Projector(nn.Module):
    """``(N, h, w, C)`` maps → ``(N, h·w/4, d)`` tokens."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        width = channels * MERGE * MERGE
        self.pre_norm = nn.LayerNorm(channels, eps=1e-5)
        self.linear_1 = nn.Linear(width, width)
        self.linear_2 = nn.Linear(width, hidden)

    def forward(self, maps: torch.Tensor) -> torch.Tensor:
        n, h, w, c = maps.shape
        x = self.pre_norm(maps)
        x = x.reshape(n, h // MERGE, MERGE, w // MERGE, MERGE, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, (h // MERGE) * (w // MERGE), MERGE * MERGE * c)
        return self.linear_2(F.gelu(self.linear_1(x)))


class GlimpseVLM(nn.Module):
    """``projector`` and ``lm``. ``forward(maps, tokens)``: ``maps``
    ``(F·B, h, w, C)`` view-major (row ``j·B + i`` is image ``i``'s
    fixation ``j``), ``tokens`` ``(B, Lt)`` caption ids (teacher forcing;
    padding is the caller's to mask). Returns ``(logits (B, Lt, vocab)
    float32, [Routing])``."""

    def __init__(self, lm: MoELMConfig, channels: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.projector = Projector(channels, lm.hidden_size)
        self.lm = MoELM(lm)

    def forward(self, maps: torch.Tensor, tokens: torch.Tensor):
        b, lt = tokens.shape
        with torch.autocast(maps.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            with span("models.vlm_projector"):
                img = self.projector(maps)                        # (F·B, 4, d)
                img = img.reshape(-1, b, img.shape[1], img.shape[2]).transpose(0, 1)
                img = img.reshape(b, -1, img.shape[-1])           # (B, F·4, d)
            n_img = img.shape[1]
            seq = torch.cat([img.to(torch.float32), self.lm.embed_tokens(tokens)], dim=1)
            at = torch.arange(n_img - 1, n_img + lt - 1, device=tokens.device)
            return self.lm(seq, at)


def init_weights_(model: GlimpseVLM, generator: torch.Generator) -> GlimpseVLM:
    """Random weights in place, as the published model initialises: every
    linear layer, the embedding and the held experts ``N(0, 0.02)`` (its
    ``initializer_range``), the router ``N(0, 1/√(3d))`` (the spread of its
    Kaiming-uniform init), biases and the router's correction bias 0,
    norms 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, HeldExperts):
                mod.gate_up_proj.normal_(0.0, 0.02, generator=generator)
                mod.down_proj.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, Router):
                mod.weight.normal_(0.0, (3 * mod.weight.shape[1]) ** -0.5, generator=generator)
                mod.e_score_correction_bias.zero_()
            elif isinstance(mod, (RMSNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
    return model


def caption_loss(logits: torch.Tensor, tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Next-token cross-entropy over the caption's real tokens (those not
    ``pad_id``), their mean."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                           ignore_index=pad_id)
