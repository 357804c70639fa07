"""Text tower and glimpse-caption decoder of the multimodal (caption) path.

Port of ``multimodal_active_ai_tpu/models/text.py``:

* :func:`tokenize`, the corpus-free hashing tokenizer (FNV-1a 32-bit over
  each lowercase word's UTF-8 bytes), and :class:`Vocabulary`, the
  corpus-built frequency vocabulary with an OOV bucket, copied as they are
  (plain Python);
* :class:`TextEncoder`: embedding, the sinusoid added to q and k only,
  post-norm encoder layers with the padding masked, a masked mean-pool and
  a projection into the shared retrieval space, float32 out;
* :class:`GlimpseCaptioner`: a causal caption decoder over projected
  glimpse features (cross-attention keys carry the memory's sinusoid).

The sinusoid is this module's own (exponent ``2·(d // 2)/dim``, sin on even
and cos on odd dimensions), not DETR's ``position_encoding``. Attention is
the DETR port's flax-semantics :class:`MultiheadAttention`; LayerNorm ε is
1e-6. Dropout is active in train mode and draws from the ``generator``
passed to ``forward``, as in :mod:`~multimodal_active_ai_tpu_torch.models.
transformer`.
"""

from __future__ import annotations

import math
import re
from collections import Counter

import numpy as np
import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.mlp import dense_init_
from multimodal_active_ai_tpu_torch.models.transformer import (
    MultiheadAttention,
    TransformerEncoderLayer,
    _FeedForward,
    _layer_norm,
)

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_RESERVED = 3
_WORD_RE = re.compile(r"[a-z0-9']+")


class Vocabulary:
    """Corpus-built frequency vocabulary (word → id) with an OOV bucket:
    ids by descending corpus frequency from 4, unknown words to id 3, and
    the OOV rate of everything encoded so far."""

    OOV_ID = 3
    _BASE = 4       # PAD/BOS/EOS/OOV reserved below

    def __init__(self, words: list[str], max_len: int = 32):
        self.words = list(words)
        self.word_to_id = {w: i + self._BASE for i, w in enumerate(self.words)}
        self.max_len = max_len
        self.oov_words = 0
        self.total_words = 0

    @property
    def size(self) -> int:
        return self._BASE + len(self.words)

    @property
    def oov_rate(self) -> float:
        return self.oov_words / self.total_words if self.total_words else 0.0

    @classmethod
    def build(cls, texts, max_size: int = 32768, min_freq: int = 1,
              max_len: int = 32) -> "Vocabulary":
        """Frequency vocabulary over lowercase word tokens; ties broken by
        first appearance."""
        counts = Counter()
        for t in texts:
            counts.update(_WORD_RE.findall(t.lower()))
        words = [w for w, n in counts.most_common() if n >= min_freq]
        return cls(words[: max_size - cls._BASE], max_len)

    def to_u8(self) -> np.ndarray:
        """The word list as a uint8 array (newline-joined UTF-8), the form
        a checkpoint keeps beside the embedding it indexes."""
        return np.frombuffer("\n".join(self.words).encode("utf-8"), np.uint8).copy()

    @classmethod
    def from_u8(cls, arr, max_len: int = 32) -> "Vocabulary":
        """Inverse of :meth:`to_u8`; ``arr`` is a numpy array or a CPU tensor."""
        blob = np.asarray(arr, dtype=np.uint8).tobytes().decode("utf-8")
        return cls(blob.split("\n") if blob else [], max_len)

    def encode(self, text: str):
        """(ids, mask) padded to ``max_len``, the :func:`tokenize` contract."""
        words = _WORD_RE.findall(text.lower())[: self.max_len - 2]
        ids = [BOS_ID]
        for w in words:
            i = self.word_to_id.get(w)
            if i is None:
                self.oov_words += 1
                i = self.OOV_ID
            ids.append(i)
        self.total_words += len(words)
        ids.append(EOS_ID)
        mask = [1] * len(ids)
        while len(ids) < self.max_len:
            ids.append(PAD_ID)
            mask.append(0)
        return ids, mask

    def decode(self, ids) -> str:
        """Inverse map (specials skipped, OOV rendered as ``<unk>``)."""
        out = []
        for i in ids:
            i = int(i)
            if i in (PAD_ID, BOS_ID, EOS_ID):
                continue
            out.append("<unk>" if i == self.OOV_ID else self.words[i - self._BASE])
        return " ".join(out)


def tokenize(text: str, vocab_size: int = 32768, max_len: int = 32):
    """Hashing-trick tokenizer: lowercase word tokens → stable bucket ids in
    ``[_RESERVED, vocab_size)``; (ids, mask) as lists padded to ``max_len``."""
    words = _WORD_RE.findall(text.lower())
    ids = [BOS_ID]
    for w in words[: max_len - 2]:
        h = 2166136261
        for ch in w.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        ids.append(_RESERVED + h % (vocab_size - _RESERVED))
    ids.append(EOS_ID)
    mask = [1] * len(ids)
    while len(ids) < max_len:
        ids.append(PAD_ID)
        mask.append(0)
    return ids, mask


def _sinusoid(length: int, dim: int, device: torch.device | str | None = None) -> torch.Tensor:
    """``(length, dim)`` float32: ``pos / 10000^(2·(d // 2)/dim)``, sin on
    even and cos on odd ``d``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim_t = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * torch.div(dim_t, 2, rounding_mode="floor") / dim)
    return torch.where(dim_t % 2 == 0, torch.sin(angle), torch.cos(angle))


def _embedding(num: int, dim: int, generator: torch.Generator | None) -> nn.Embedding:
    """flax ``Embed``'s default init: truncated normal, std 1/√dim."""
    emb = nn.Embedding(num, dim)
    std = math.sqrt(1.0 / dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(emb.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    return emb


def _linear(n_in: int, n_out: int, generator: torch.Generator | None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    dense_init_(layer, generator)
    return layer


class TextEncoder(nn.Module):
    """Embedding + sinusoid positions + N encoder layers + masked mean-pool
    + projection to the shared retrieval space."""

    def __init__(self, vocab_size: int = 32768, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 4, dim_feedforward: int = 1024, out_dim: int = 128,
                 dropout: float = 0.1, generator: torch.Generator | None = None):
        super().__init__()
        self.embed = _embedding(vocab_size, d_model, generator)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    generator=generator) for _ in range(num_layers)])
        self.proj = _linear(d_model, out_dim, generator)

    def forward(self, token_ids: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``token_ids`` ``(B, L)`` integer; PAD_ID positions are masked
        out; ``generator`` the dropout stream (train mode). Returns
        ``(B, out_dim)`` float32."""
        pad = token_ids == PAD_ID
        x = self.embed(token_ids)
        pos = _sinusoid(token_ids.shape[1], x.shape[-1], x.device)[None]
        for layer in self.layers:
            x = layer(x, pos, pad, generator=generator)
        keep = (~pad)[..., None].to(x.dtype)
        pooled = (x * keep).sum(1) / torch.clamp_min(keep.sum(1), 1)
        return self.proj(pooled).to(torch.float32)


class _CausalDecoderLayer(_FeedForward):
    """Causal self-attention (no positional term), cross-attention into the
    memory (its sinusoid on the keys only), feed-forward; post-norm after
    each, dropout on the attention weights and the hidden layer only."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float,
                 generator: torch.Generator | None = None):
        super().__init__(d_model, dim_feedforward, dropout, generator)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout, generator)
        self.norm1 = _layer_norm(d_model)
        self.norm2 = _layer_norm(d_model)
        self.norm3 = _layer_norm(d_model)

    def forward(self, x, memory, mem_pos, causal, mem_pad=None, generator=None):
        g = generator
        x = self.norm1(x + self.self_attn(x, x, x, attn_mask=causal, generator=g))
        x = self.norm2(x + self.multihead_attn(x, memory + mem_pos, memory, mem_pad,
                                               generator=g))
        return self.norm3(x + self.ff(x, g))


class GlimpseCaptioner(nn.Module):
    """Caption decoder over glimpse-sequence memory: glimpse features are
    projected into the model width and attended by a causal decoder;
    logits over the vocabulary."""

    def __init__(self, feat_dim: int, vocab_size: int = 32768, d_model: int = 256,
                 nhead: int = 8, num_layers: int = 4, dim_feedforward: int = 1024,
                 dropout: float = 0.1, generator: torch.Generator | None = None):
        super().__init__()
        self.memory_proj = _linear(feat_dim, d_model, generator)
        self.embed = _embedding(vocab_size, d_model, generator)
        self.layers = nn.ModuleList([
            _CausalDecoderLayer(d_model, nhead, dim_feedforward, dropout, generator)
            for _ in range(num_layers)])
        self.norm = _layer_norm(d_model)
        self.head = _linear(d_model, vocab_size, generator)

    def forward(self, glimpse_feats: torch.Tensor, token_ids: torch.Tensor,
                glimpse_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``glimpse_feats`` ``(B, S, F)``; ``token_ids`` ``(B, L)`` caption
        prefix (teacher forcing); ``glimpse_mask`` ``(B, S)`` bool, True on
        padded glimpses; ``generator`` the dropout stream (train mode).
        Returns ``(B, L, vocab)`` float32 logits."""
        s, length = glimpse_feats.shape[1], token_ids.shape[1]
        memory = self.memory_proj(glimpse_feats)
        d, dev = memory.shape[-1], memory.device
        mem_pos = _sinusoid(s, d, dev)[None]
        x = self.embed(token_ids) + _sinusoid(length, d, dev)[None]
        causal = torch.ones(length, length, dtype=torch.bool, device=dev).tril()
        for layer in self.layers:
            x = layer(x, memory, mem_pos, causal, glimpse_mask, generator=generator)
        return self.head(self.norm(x)).to(torch.float32)
