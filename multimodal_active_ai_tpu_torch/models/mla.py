"""Multi-head latent attention (MLA), DeepSeek-V2/V3's attention, with its
RMSNorm and decoupled rotary embedding.

As the published ``DeepseekV3Attention`` computes it with no query
compression (``q_lora_rank`` null), per token ``x`` of width ``d``:

* ``q = W_q·x``, per head split into ``q_nope`` (``qk_nope_head_dim``) and
  ``q_pe`` (``qk_rope_head_dim``);
* ``[c_kv, k_pe] = W_kva·x`` (``kv_lora_rank`` + ``qk_rope_head_dim``),
  then ``c_kv ← RMSNorm(c_kv)`` (ε 1e-6, the published default);
* ``[k_nope, v] = W_kvb·c_kv``, per head;
* RoPE (θ ``rope_theta``) on ``q_pe`` and on ``k_pe``, which every head
  shares; the published code first moves each rotated pair ``(2i, 2i+1)``
  to ``(i, i + r/2)`` and then rotates halves, and so does this one;
* ``softmax(q·kᵀ/√(nope + rope))·v`` under a causal mask, with
  ``q = [q_nope, q_pe]``, ``k = [k_nope, k_pe]``, then ``W_o``.

The product runs in ``scaled_dot_product_attention`` (its backend is the
one torch picks for a query and key of ``nope + rope`` = 192 and a value of
128 a head). Under autocast the projections and the attention run in its
dtype, RMSNorm in float32, as the published code does in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.utils.profiling import span


class RMSNorm(nn.Module):
    """``w · x / √(mean(x²) + ε)``, the statistics in float32, the result in
    the input's dtype before the weight (``DeepseekV3RMSNorm``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


def rope_tables(length: int, dim: int, theta: float, device, dtype) -> tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """``(cos, sin)`` ``(length, dim)`` for positions ``0 … length−1``:
    ``inv_freq = θ^(−2i/dim)``, the angles repeated over both halves,
    computed in float32 and returned in ``dtype``."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)
    ang = torch.outer(torch.arange(length, device=device, dtype=torch.float32), inv)
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb`` on ``(..., L, r)``: pairs
    ``(2i, 2i+1)`` regrouped into halves, then ``x·cos + rotate_half(x)·sin``."""
    r = x.shape[-1]
    x = x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., : r // 2], x[..., r // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class MLA(nn.Module):
    """``(B, L, d) → (B, L, d)``, causal. Submodule names are the published
    checkpoint's (``q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
    ``kv_b_proj``, ``o_proj``)."""

    def __init__(self, hidden: int, heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, rope_theta: float):
        super().__init__()
        self.heads, self.rank = heads, kv_lora_rank
        self.nope, self.rope, self.dv = qk_nope_head_dim, qk_rope_head_dim, v_head_dim
        self.theta = rope_theta
        self.q_proj = nn.Linear(hidden, heads * (qk_nope_head_dim + qk_rope_head_dim), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(hidden, kv_lora_rank + qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank)
        self.kv_b_proj = nn.Linear(kv_lora_rank, heads * (qk_nope_head_dim + v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(heads * v_head_dim, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("models.lm.attention"):
            return self._attend(x)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        h = self.heads
        q = self.q_proj(x).view(b, length, h, self.nope + self.rope).transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv))
        kv = kv.view(b, length, h, self.nope + self.dv).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.dv], dim=-1)
        cos, sin = rope_tables(length, self.rope, self.theta, x.device, v.dtype)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.view(b, 1, length, self.rope), cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, h, length, self.rope)], dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.transpose(1, 2).reshape(b, length, h * self.dv))

