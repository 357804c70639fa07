"""The DeepSeek-V3 language model of Kimi-VL-A3B: MLA and a mixture of
experts, one expert-parallel rank's share of it.

``num_hidden_layers`` pre-norm decoder layers (RMSNorm ε ``rms_norm_eps``,
residuals around each half): MLA (``models/mla.py``), then the first
``first_k_dense_replace`` layers a SwiGLU of ``intermediate_size``, the
others an :class:`~multimodal_active_ai_tpu_torch.models.moe.MoE` holding
the routed experts ``held``. Then the final RMSNorm and the head.

The embedding and the head span the rank's slice of the vocabulary
(``vocab_size`` rows): ids, logits and loss are over the slice. The input
is a sequence of embeddings (``(B, L, d)``; the caption model puts the
image tokens before the text's), positions ``0 … L−1``, causal; the head
runs on the positions in ``head_positions`` only. Names follow the
published checkpoint (``embed_tokens``, ``layers.{i}.self_attn``,
``input_layernorm``, ``post_attention_layernorm``, ``mlp``, ``norm``,
``lm_head``); the held experts are stacked (``models/moe.HeldExperts``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mla import MLA, RMSNorm
from multimodal_active_ai_tpu_torch.models.moe import MoE, Routing, SwiGLU
from multimodal_active_ai_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class MoELMConfig:
    """The published ``config.json`` keys the model reads, and ``held``:
    the first and one-past-last routed expert this rank holds."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    held: tuple[int, int] = (0, 64)

    @classmethod
    def from_dict(cls, d: dict) -> "MoELMConfig":
        keys = set(cls.__dataclass_fields__)
        cfg = {k: v for k, v in d.items() if k in keys}
        if "held" in cfg:
            cfg["held"] = tuple(cfg["held"])
        return cls(**cfg)


# The Kimi-VL-A3B-Instruct language model's own widths (its config.json).
KIMI_VL_A3B = MoELMConfig()


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoELMConfig, index: int):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = MLA(d, cfg.num_attention_heads, cfg.kv_lora_rank,
                             cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                             cfg.rope_theta)
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        if index < cfg.first_k_dense_replace:
            self.mlp = SwiGLU(d, cfg.intermediate_size)
        else:
            self.mlp = MoE(d, cfg.n_routed_experts, cfg.num_experts_per_tok,
                           cfg.moe_intermediate_size, cfg.n_shared_experts,
                           cfg.routed_scaling_factor, range(*cfg.held))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, Routing | None]:
        x = x + self.self_attn(self.input_layernorm(x))
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            out, routing = self.mlp(h)
            return x + out, routing
        return x + self.mlp(h), None


class MoELM(nn.Module):
    """``forward(embeds (B, L, d), head_positions (n,)) → (logits (B, n,
    vocab) float32, [Routing of each MoE layer])``."""

    def __init__(self, cfg: MoELMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([DecoderLayer(cfg, i)
                                     for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, embeds: torch.Tensor, head_positions: torch.Tensor):
        routing = []
        with span("models.lm"):
            x = embeds
            for layer in self.layers:
                x, r = layer(x)
                if r is not None:
                    routing.append(r)
            with span("models.lm.head"):
                h = self.norm(x.index_select(1, head_positions))
                return self.lm_head(h).float(), routing
