"""DETR encoder-decoder transformer over the saccade axis.

Port of ``multimodal_active_ai_tpu/models/transformer.py`` (reference
``detr_CLA/models/transformer.py``), batch-first ``(B, S, C)``:

* attention as flax's ``MultiHeadDotProductAttention``: q, k and v are
  projected from three inputs (the positional embedding is added to q and k,
  never to v), q is scaled by ``1/sqrt(head_dim)``, padded keys take the
  dtype's most negative value (not ``-inf``), and dropout falls on the
  attention weights;
* post-norm (default) and pre-norm layers; the pre-norm encoder ends in a
  LayerNorm, the post-norm one does not;
* LayerNorm ε = 1e-6 (flax's default, not torch's 1e-5);
* ``return_intermediate_dec`` stacks ``decoder.norm`` of every decoder
  layer's output.

Submodule names are the reference's (``encoder.layers.i.self_attn.
in_proj_weight``, ``linear1``, ``norm1``, ``decoder.norm`` ...), so the
``state_dict`` is the ``detr_CLA`` layout.

Dropout is flax's, in train mode only, and draws from the ``generator``
that the caller passes to ``forward`` (a train step's dropout stream; flax
raises without its ``dropout`` key, and so does this module):

* on the attention weights, one keep mask of shape ``(1, 1, Sq, Sk)`` for
  the whole batch and every head (flax's ``broadcast_dropout=True``);
* on activations (the residual branches and the feed-forward hidden layer),
  an element-wise mask drawn for the **global** batch, ``world·B`` rows,
  of which this rank keeps its own (``parallel.local_rows``).

Both are the same draw on every rank, so an N-rank step equals the 1-rank
step of the global batch, dropout included. Each kept value is scaled by
``1/(1 - rate)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import dense_init_
from multimodal_active_ai_tpu_torch.parallel import local_rows, world_size

LN_EPS = 1e-6


def _draw(shape, rate: float, generator: torch.Generator | None,
          device: torch.device) -> torch.Tensor:
    """A bool keep mask of ``shape`` (each element kept with probability
    ``1 - rate``) from ``generator``; dropout without one raises."""
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit generator: "
                         "pass forward(..., generator=)")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout`` of ``x`` (``(B, ...)``, this rank's rows): the
    keep mask is drawn for the global batch and sliced to this rank's rows;
    kept values are scaled by ``1/(1 - rate)``. ``rate`` 0 returns ``x``."""
    if not rate:
        return x
    shape = (x.shape[0] * world_size(),) + tuple(x.shape[1:])
    keep = local_rows(_draw(shape, rate, generator, x.device))
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class MultiheadAttention(nn.Module):
    """Attention with the reference's packed ``in_proj_weight`` ``(3d, d)``
    (rows q, k, v) and ``out_proj``, computing flax's attention."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.nhead = nhead
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        # lecun-normal (fan_in = d_model) for q, k, v and out, zero biases
        std = math.sqrt(1.0 / d_model) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.in_proj_weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        dense_init_(self.out_proj, generator)

    def _heads(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Projection ``i`` (0 q, 1 k, 2 v) of ``x`` ``(B, S, d)`` split into
        heads, ``(B, h, S, d/h)``."""
        d, h = x.shape[-1], self.nhead
        y = F.linear(x, self.in_proj_weight[i * d:(i + 1) * d],
                     self.in_proj_bias[i * d:(i + 1) * d])
        return y.view(x.shape[0], x.shape[1], h, d // h).transpose(1, 2)

    def attention_weights(self, q: torch.Tensor, k: torch.Tensor,
                          key_padding_mask: torch.Tensor | None = None,
                          attn_mask: torch.Tensor | None = None,
                          generator: torch.Generator | None = None) -> torch.Tensor:
        """The softmax weights ``(B, h, Sq, Sk)``, in train mode times one
        ``(1, 1, Sq, Sk)`` keep mask over ``1 - dropout`` (flax's
        ``dot_product_attention_weights`` with ``broadcast_dropout``)."""
        qh = self._heads(q, 0) / math.sqrt(q.shape[-1] // self.nhead)
        logits = qh @ self._heads(k, 1).transpose(-1, -2)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        if self.training and self.dropout:
            keep = _draw((1, 1) + tuple(weights.shape[-2:]), self.dropout, generator,
                         weights.device)
            weights = weights * (keep.to(weights.dtype) / (1.0 - self.dropout))
        return weights

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: torch.Tensor | None = None,
                attn_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``q`` ``(B, Sq, d)``, ``k``/``v`` ``(B, Sk, d)``; ``key_padding_mask``
        ``(B, Sk)`` bool, True on padded keys; ``attn_mask`` a bool keep-mask
        (True = attend, flax's ``mask``) that broadcasts to ``(B, h, Sq, Sk)``,
        such as a causal ``(Sq, Sk)`` lower triangle; ``generator`` the
        dropout stream (train mode)."""
        weights = self.attention_weights(q, k, key_padding_mask, attn_mask, generator)
        out = (weights @ self._heads(v, 2)).transpose(1, 2)
        return self.out_proj(out.reshape(q.shape[0], q.shape[1], q.shape[-1]))


class _FeedForward(nn.Module):
    """``linear1 → relu → dropout → linear2`` and the residual dropout,
    shared by the layer kinds."""

    def __init__(self, d_model: int, dim_feedforward: int, rate: float,
                 generator: torch.Generator | None):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        dense_init_(self.linear1, generator)
        dense_init_(self.linear2, generator)
        self.rate = rate

    def drop(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return dropout(x, self.rate if self.training else 0.0, generator)

    def ff(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return self.linear2(self.drop(F.relu(self.linear1(x)), generator))


class TransformerEncoderLayer(_FeedForward):
    """Post- or pre-norm encoder layer (``transformer.py:132-189``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, normalize_before: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(d_model, dim_feedforward, dropout, generator)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.norm1 = _layer_norm(d_model)
        self.norm2 = _layer_norm(d_model)
        self.normalize_before = normalize_before

    def forward(self, src, pos, src_key_padding_mask=None, generator=None):
        g = generator
        if self.normalize_before:
            src2 = self.norm1(src)
            q = src2 + pos
            src = src + self.drop(
                self.self_attn(q, q, src2, src_key_padding_mask, generator=g), g)
            return src + self.drop(self.ff(self.norm2(src), g), g)
        q = src + pos
        src = self.norm1(src + self.drop(
            self.self_attn(q, q, src, src_key_padding_mask, generator=g), g))
        return self.norm2(src + self.drop(self.ff(src, g), g))


class TransformerDecoderLayer(_FeedForward):
    """Self-attention over the queries, cross-attention into the encoder
    memory (``transformer.py:192-274``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, normalize_before: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(d_model, dim_feedforward, dropout, generator)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.norm1 = _layer_norm(d_model)
        self.norm2 = _layer_norm(d_model)
        self.norm3 = _layer_norm(d_model)
        self.normalize_before = normalize_before

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                generator=None):
        g = generator
        if self.normalize_before:
            tgt2 = self.norm1(tgt)
            q = tgt2 + query_pos
            tgt = tgt + self.drop(self.self_attn(q, q, tgt2, generator=g), g)
            tgt2 = self.norm2(tgt)
            tgt = tgt + self.drop(self.multihead_attn(
                tgt2 + query_pos, memory + pos, memory, memory_key_padding_mask, generator=g), g)
            return tgt + self.drop(self.ff(self.norm3(tgt), g), g)
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.drop(self.self_attn(q, q, tgt, generator=g), g))
        tgt = self.norm2(tgt + self.drop(self.multihead_attn(
            tgt + query_pos, memory + pos, memory, memory_key_padding_mask, generator=g), g))
        return self.norm3(tgt + self.drop(self.ff(tgt, g), g))


class _Stack(nn.Module):
    """``layers`` and an optional final ``norm`` (the reference's
    ``TransformerEncoder``/``TransformerDecoder`` names)."""

    def __init__(self, layers: list[nn.Module], norm: nn.Module | None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class Transformer(nn.Module):
    """The DETR transformer; ``forward`` returns ``(hs, memory)`` with ``hs``
    ``(dec_layers, B, Q, C)`` when ``return_intermediate_dec`` (the DETR
    build default), else ``(1, B, Q, C)``."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 normalize_before: bool = False, return_intermediate_dec: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, normalize_before, generator)
        self.encoder = _Stack([TransformerEncoderLayer(*args) for _ in range(num_encoder_layers)],
                              _layer_norm(d_model) if normalize_before else None)
        self.decoder = _Stack([TransformerDecoderLayer(*args) for _ in range(num_decoder_layers)],
                              _layer_norm(d_model))
        self.return_intermediate_dec = return_intermediate_dec

    def forward(self, src, mask, query_embed, pos_embed, generator=None):
        """``src`` ``(B, S, C)``; ``mask`` ``(B, S)`` bool (True = padded
        saccade) or None; ``query_embed`` ``(Q, C)``; ``pos_embed`` ``(B, S, C)``;
        ``generator`` the dropout stream (train mode)."""
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, pos_embed, mask, generator=generator)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, pos_embed, query_pos, mask, generator=generator)
            if self.return_intermediate_dec:
                intermediate.append(self.decoder.norm(tgt))
        hs = torch.stack(intermediate) if self.return_intermediate_dec \
            else self.decoder.norm(tgt)[None]
        return hs, memory


def build_transformer(hidden_dim: int = 256, dropout: float = 0.1, nheads: int = 8,
                      dim_feedforward: int = 2048, enc_layers: int = 6,
                      dec_layers: int = 6, pre_norm: bool = False,
                      generator: torch.Generator | None = None) -> Transformer:
    """``build_transformer`` (``transformer.py:281-291``)."""
    return Transformer(d_model=hidden_dim, dropout=dropout, nhead=nheads,
                       dim_feedforward=dim_feedforward, num_encoder_layers=enc_layers,
                       num_decoder_layers=dec_layers, normalize_before=pre_norm,
                       return_intermediate_dec=True, generator=generator)
