"""The DETR glimpse-sequence classifier and its training step, plain.

DETR (Carion et al. 2020, arXiv:2005.12872) as the reference's
``detr_CLA`` classifier uses it: the foveated ResNet with frozen
BatchNorm embeds each of ``S`` glimpse stacks; the ``(C, 4, 4)`` map,
flattened C-major, goes through ``input_proj`` (a 1×1 Conv1d) to
``d_model``; sine embeddings of the saccade coordinates position the
tokens; a post-norm encoder-decoder transformer (flax attention: q scaled
by ``1/√d_head``, the positional embedding added to q and k only, padded
keys at the dtype's lowest value, LayerNorm ε = 1e-6) turns ``Q`` learned
queries into class logits after each decoder layer (``decoder.norm`` then
``class_embed``); the loss is the cross-entropy of the last layer's logits
against the image label at every query (identity matching).

Dropout (rate ``p``, train mode) is drawn from the step's generator in the
order the documented semantics fix: in each attention, one keep mask of
shape ``(1, 1, Sq, Sk)`` for the batch and every head on the softmax
weights; on each residual branch and the feed-forward hidden layer, an
element-wise mask over the global batch's rows. Each kept value is scaled
by ``1 / (1 − p)``.

The step: glimpses of the batch at its saccades (``num_fixs`` real ones,
the rest padding), forward, loss, backward, the global-norm clip over
every gradient (the frozen stem's and layer1's included), AdamW on the
``head`` group at ``lr`` and the ``backbone`` group (layer2-4) at
``lr_backbone``, each times the StepLR factor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.optim import clip_by_global_norm
from benchmark.reference.precision import EXACT
from benchmark.reference.resnet import Linear, ResNet


class Dropper:
    """Draws keep masks from one generator, in call order."""

    def __init__(self, rate: float, generator: torch.Generator | None):
        self.rate, self.gen = rate, generator

    def keep(self, shape, device):
        return torch.rand(shape, generator=self.gen, device=device) < 1.0 - self.rate

    def __call__(self, x):
        if not self.rate or self.gen is None:
            return x
        return torch.where(self.keep(x.shape, x.device), x / (1.0 - self.rate), 0.0)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))

    def init_plan(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
        return []

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-6)


class Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d)

    def init_plan(self):
        with torch.no_grad():
            self.in_proj_bias.zero_()
        return [(self.in_proj_weight, math.sqrt(1.0 / self.in_proj_weight.shape[1]))]

    def _proj(self, x, i, prec):
        d = x.shape[-1]
        y = prec.q(x) @ prec.q(self.in_proj_weight[i * d:(i + 1) * d]).T \
            + self.in_proj_bias[i * d:(i + 1) * d]
        return y.view(x.shape[0], x.shape[1], self.heads, d // self.heads).transpose(1, 2)

    def forward(self, q, k, v, pad, drop: Dropper, prec):
        dh = q.shape[-1] // self.heads
        logits = prec.q(self._proj(q, 0, prec) / math.sqrt(dh)) @ prec.q(self._proj(k, 1, prec)).transpose(-1, -2)
        if pad is not None:
            logits = logits.masked_fill(pad[:, None, None, :], torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if drop.rate and drop.gen is not None:
            keep = drop.keep((1, 1) + tuple(w.shape[-2:]), w.device)
            w = w * (keep.to(w.dtype) / (1.0 - drop.rate))
        out = (prec.q(w) @ prec.q(self._proj(v, 2, prec))).transpose(1, 2)
        return self.out_proj(out.reshape(q.shape), prec)


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, ff):
        super().__init__()
        self.self_attn = Attention(d, heads)
        self.linear1, self.linear2 = Linear(d, ff), Linear(ff, d)
        self.norm1, self.norm2 = LayerNorm(d), LayerNorm(d)

    def forward(self, src, pos, pad, drop, prec):
        q = src + pos
        src = self.norm1(src + drop(self.self_attn(q, q, src, pad, drop, prec)))
        ff = self.linear2(drop(F.relu(self.linear1(src, prec))), prec)
        return self.norm2(src + drop(ff))


class DecoderLayer(nn.Module):
    def __init__(self, d, heads, ff):
        super().__init__()
        self.self_attn, self.multihead_attn = Attention(d, heads), Attention(d, heads)
        self.linear1, self.linear2 = Linear(d, ff), Linear(ff, d)
        self.norm1, self.norm2, self.norm3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)

    def forward(self, tgt, memory, pos, query_pos, pad, drop, prec):
        q = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(q, q, tgt, None, drop, prec)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            tgt + query_pos, memory + pos, memory, pad, drop, prec)))
        ff = self.linear2(drop(F.relu(self.linear1(tgt, prec))), prec)
        return self.norm3(tgt + drop(ff))


class _Layers(nn.Module):
    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class Transformer(nn.Module):
    def __init__(self, d, heads, ff, enc, dec):
        super().__init__()
        self.encoder = _Layers([EncoderLayer(d, heads, ff) for _ in range(enc)])
        self.decoder = _Layers([DecoderLayer(d, heads, ff) for _ in range(dec)], LayerNorm(d))


class _Body(nn.Module):
    def __init__(self, body):
        super().__init__()
        self.body = body


class InputProj(nn.Module):
    """``Conv1d(cin → d, k = 1)``, weight ``(d, cin, 1)``."""

    def __init__(self, cin, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, cin, 1))
        self.bias = nn.Parameter(torch.empty(d))

    def init_plan(self):
        with torch.no_grad():
            self.bias.zero_()
        return [(self.weight, math.sqrt(1.0 / self.weight.shape[1]))]

    def forward(self, x, prec):
        return prec.q(x) @ prec.q(self.weight[:, :, 0]).T + self.bias


class Queries(nn.Module):
    def __init__(self, q, d):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(q, d))

    def init_plan(self):
        return [(self.weight, 1.0)]


def sine_embedding(saccades: torch.Tensor, d: int) -> torch.Tensor:
    """``(B, S, 2)`` (x, y) in [0, 1) → ``(B, S, d)``: each coordinate ×100,
    over its maximum along S (+1e-6), ×2π, against ``10000^(2⌊i/2⌋/(d/2))``,
    sine and cosine interleaved; coordinate 0 fills the first half."""
    n = d // 2
    dim_t = torch.arange(n, dtype=torch.float32, device=saccades.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / n)
    out = []
    for c in range(2):
        e = saccades[..., c].float() * 100.0
        e = e / (e.amax(dim=1, keepdim=True) + 1e-6) * (2 * math.pi)
        p = e[..., None] / dim_t
        out.append(torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2))
    return torch.cat(out, -1)


class DETR(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        body = ResNet(cfg["block"], cfg["layers"], 3 * len(cfg["retina"]["crop_sizes"]),
                      frozen=True, residual_gamma=cfg["residual_gamma"])
        self.backbone = nn.ModuleList([_Body(body)])
        d = cfg["hidden_dim"]
        self.transformer = Transformer(d, cfg["nheads"], cfg["dim_feedforward"],
                                       cfg["enc_layers"], cfg["dec_layers"])
        fmap = cfg["feature_map"]
        self.input_proj = InputProj(body.out_channels * fmap * fmap, d)
        self.query_embed = Queries(cfg["num_queries"], d)
        self.class_embed = Linear(d, cfg["num_classes"])
        self.d = d

    def forward(self, glimpses, saccades, pad, drop: Dropper, prec=EXACT):
        b, s = glimpses.shape[:2]
        feats = self.backbone[0].body(glimpses.reshape((b * s,) + glimpses.shape[2:]), prec)
        src = self.input_proj(feats.reshape(b, s, -1), prec)
        pos = sine_embedding(saccades, self.d)
        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, pos, pad, drop, prec)
        query_pos = self.query_embed.weight[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        for layer in self.transformer.decoder.layers:
            tgt = layer(tgt, memory, pos, query_pos, pad, drop, prec)
        return self.class_embed(self.transformer.decoder.norm(tgt), prec)


TRAINABLE = ("layer2", "layer3", "layer4")
BODY = "backbone.0.body."


def groups(model: DETR) -> dict[str, str]:
    """``{name: 'head' | 'backbone' | 'frozen'}``: the stem and layer1 are
    frozen, layer2-4 are the backbone group, the rest the head."""
    out = {}
    for n, _ in model.named_parameters():
        if n.startswith(BODY):
            out[n] = "backbone" if n[len(BODY):].startswith(TRAINABLE) else "frozen"
        else:
            out[n] = "head"
    return out


def train_step(model: DETR, opt, cfg: dict, factor: float, glimpses, saccades, num_fixs: int,
               labels, generator, prec=EXACT, on_first_update=None):
    """One update; returns the loss. ``opt`` holds the head and backbone
    parameters; every parameter's gradient counts in the clip's norm."""
    model.train()
    b, s = glimpses.shape[:2]
    pad = (torch.arange(s, device=glimpses.device) >= num_fixs)[None].expand(b, s)
    logits = model(glimpses, saccades, pad, Dropper(cfg["dropout"], generator), prec)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels[:, None].expand(b, logits.shape[1]).reshape(-1))
    for p in model.parameters():
        p.grad = None
    loss.backward()
    clip_by_global_norm([p.grad for p in model.parameters()], cfg["clip_max_norm"])
    if on_first_update is not None:
        on_first_update({n: p.grad for n, p in opt.params.items()})
    lab = groups(model)
    base = {"head": cfg["lr"], "backbone": cfg["lr_backbone"]}
    opt.step({n: base[lab[n]] * factor for n in opt.params})
    return loss.detach()
