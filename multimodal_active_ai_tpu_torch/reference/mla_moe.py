"""Kimi-VL-A3B's language model, DeepSeek-V3's MLA and mixture of experts,
with a glimpse projector in front: forward, loss, gradient and update,
plain.

It follows the published ``modeling_deepseek.py`` (DeepSeek-V3, as
Kimi-VL's language model uses it) and the DeepSeek-V3 report for what that
code leaves to training:

* RMSNorm ``x·rsqrt(mean(x²) + ε)·w`` (ε ``rms_norm_eps``; 1e-6 at
  ``kv_a_layernorm``, the published default);
* MLA without query compression: ``q_proj``, ``kv_a_proj_with_mqa`` into
  ``[c_kv, k_pe]``, ``kv_a_layernorm`` on ``c_kv``, ``kv_b_proj`` into
  ``[k_nope, v]`` a head, the published ``apply_rotary_pos_emb`` (pairs
  ``(2i, 2i+1)`` regrouped into halves, ``rotate_half``) at positions
  ``0 … L−1`` on ``q_pe`` and the shared ``k_pe``, ``softmax(q·kᵀ)·(nope +
  rope)^−½`` under a causal mask, softmax in float32, ``o_proj``;
* the router of ``MoEGate`` (sigmoid scores in float32, ``noaux_tc``:
  top-k of ``scores + e_score_correction_bias``, weights the scores of the
  chosen, over their sum + 1e-20, times ``routed_scaling_factor``);
* the routed experts ``down(silu(gate(x))·up(x))`` summed at their weights,
  plus the shared experts (one MLP of ``n_shared·moe_intermediate_size``);
* the DeepSeek-V3 report's sequence-wise balance loss and its
  auxiliary-loss-free bias rule ``bᵢ ← bᵢ + γ·sign(mean load − loadᵢ)``.

Departures, each noted:

* the published code is for inference (``noaux_tc`` asserts not training);
  the balance loss and the bias rule are the report's, and its indicator
  counts the experts actually chosen (``s + b``), as the published
  auxiliary-loss code counts ``topk_idx``;
* ``n_group = topk_group = 1``: the published group limit keeps the one
  group, so it is left out;
* a layer holds the routed experts ``held`` (one expert-parallel rank's
  share) and computes their part alone; with ``held`` every expert it is
  the published layer. Its held experts' weights are stacked
  (``experts.gate_up_proj`` ``(n, 2w, d)``: each expert's ``gate_proj``
  rows over its ``up_proj`` rows; ``experts.down_proj`` ``(n, d, w)``),
  where the published checkpoint has one module an expert;
* the embedding and the head span a slice of the vocabulary, ``vocab_size``
  rows;
* the head runs on the caption's positions only (teacher forcing);
* in front, not Kimi-VL's MoonViT but the glimpse projector
  (``models/glimpse_vlm.py``): LayerNorm(C) ε 1e-5 a position, the 2×2
  merge into tokens of ``4C``, Linear, GELU (erf), Linear into ``d``;
* the optimizer is AdamW (β 0.9, 0.999, ε 1e-8, decoupled decay ``p ←
  p·(1 − lr·wd)``) after the global-norm clip, with the sums of squares in
  float64.

Every product is a float32 ``@`` whose operands pass through ``prec.q``
(:data:`EXACT` leaves them be; a control rounds them); no fused attention,
no grouped product, no kernel of the port. :func:`exact_products` turns
TF32 off for matmul and cuDNN. A train step runs the batch in blocks of
sequences and accumulates the gradient, so that the float32 model fits
where the batch's activations would not. It imports only ``torch``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the published initializer_range
STD = 0.02


class Exact:
    name = "float32"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x


EXACT = Exact()


def exact_products() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Linear(nn.Module):
    """``x·Wᵀ (+ b)``; init ``N(0, STD)``, bias 0."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_plan(self):
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()
        return [(self.weight, STD)]

    def forward(self, x, prec):
        y = prec.q(x) @ prec.q(self.weight).T
        return y if self.bias is None else y + self.bias


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps

    def init_plan(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
        return []

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.eps = eps

    def init_plan(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
        return []

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).pow(2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))

    def init_plan(self):
        return [(self.weight, STD)]

    def forward(self, ids):
        return self.weight[ids]


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def rotary(length: int, dim: int, theta: float, device):
    """The published rotary cache: ``(cos, sin)`` ``(L, dim)``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float() / dim))
    freqs = torch.outer(torch.arange(length, device=device).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """The published function at positions ``0 … L−1``."""
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


class Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, h = c["hidden_size"], c["num_attention_heads"]
        self.h, self.rank = h, c["kv_lora_rank"]
        self.nope, self.rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        self.dv = c["v_head_dim"]
        self.theta = c["rope_theta"]
        self.q_proj = Linear(d, h * (self.nope + self.rope))
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope)
        self.kv_a_layernorm = RMSNorm(self.rank, 1e-6)
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.dv))
        self.o_proj = Linear(h * self.dv, d)

    def forward(self, x, prec):
        b, s, _ = x.shape
        q = self.q_proj(x, prec).view(b, s, self.h, self.nope + self.rope).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [self.nope, self.rope], dim=-1)
        ckv, k_pe = torch.split(self.kv_a_proj_with_mqa(x, prec), [self.rank, self.rope], dim=-1)
        k_pe = k_pe.view(b, s, 1, self.rope).transpose(1, 2)
        kv = self.kv_b_proj(self.kv_a_layernorm(ckv), prec)
        kv = kv.view(b, s, self.h, self.nope + self.dv).transpose(1, 2)
        k_nope, v = torch.split(kv, [self.nope, self.dv], dim=-1)
        cos, sin = rotary(s, self.rope, self.theta, x.device)
        q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, self.h, s, self.rope)], dim=-1)
        w = (prec.q(q) @ prec.q(k).transpose(2, 3)) * (self.nope + self.rope) ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        w = torch.softmax(w.masked_fill(causal, float("-inf")), dim=-1)
        out = (prec.q(w) @ prec.q(v)).transpose(1, 2).reshape(b, s, self.h * self.dv)
        return self.o_proj(out, prec)


class MLP(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj, self.up_proj = Linear(d, width), Linear(d, width)
        self.down_proj = Linear(width, d)

    def forward(self, x, prec):
        return self.down_proj(silu(self.gate_proj(x, prec)) * self.up_proj(x, prec), prec)


class Gate(nn.Module):
    """The router: weight ``(E, d)`` (init ``N(0, 1/√(3d))``, the spread of
    the published Kaiming-uniform init), buffer ``e_score_correction_bias``
    (0)."""

    def __init__(self, d: int, experts: int, top_k: int, scaling: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, d))
        self.register_buffer("e_score_correction_bias", torch.empty(experts))
        self.top_k, self.scaling = top_k, scaling

    def init_plan(self):
        with torch.no_grad():
            self.e_score_correction_bias.zero_()
        return [(self.weight, 1.0 / math.sqrt(3 * self.weight.shape[1]))]

    def forward(self, x, prec):
        scores = torch.sigmoid(prec.q(x) @ prec.q(self.weight).T)
        choice = scores.detach() + self.e_score_correction_bias
        idx = torch.topk(choice, k=self.top_k, dim=-1, sorted=False).indices
        w = scores.gather(1, idx)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling, scores


class Experts(nn.Module):
    def __init__(self, n: int, d: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * width, d))
        self.down_proj = nn.Parameter(torch.empty(n, d, width))
        self.width = width

    def init_plan(self):
        return [(self.gate_up_proj, STD), (self.down_proj, STD)]

    def forward(self, j: int, x, prec):
        h = prec.q(x) @ prec.q(self.gate_up_proj[j]).T
        a = silu(h[:, : self.width]) * h[:, self.width:]
        return prec.q(a) @ prec.q(self.down_proj[j]).T


class MoE(nn.Module):
    def __init__(self, c: dict, held: range):
        super().__init__()
        d, w = c["hidden_size"], c["moe_intermediate_size"]
        self.held = held
        self.gate = Gate(d, c["n_routed_experts"], c["num_experts_per_tok"],
                         c["routed_scaling_factor"])
        self.experts = Experts(len(held), d, w)
        self.shared_experts = MLP(d, c["n_shared_experts"] * w)

    def forward(self, x, prec):
        b, s, d = x.shape
        flat = x.reshape(-1, d)
        idx, w, scores = self.gate(flat, prec)
        y = torch.zeros_like(flat)
        for j, e in enumerate(self.held):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                y = y.index_add(0, tok, self.experts(j, flat[tok], prec) * w[tok, slot, None])
        y = y + self.shared_experts(flat, prec)
        load = torch.bincount(idx.flatten(), minlength=scores.shape[1])
        return y.view(b, s, d), (scores, idx, load)


class Layer(nn.Module):
    def __init__(self, c: dict, i: int, held: range):
        super().__init__()
        d = c["hidden_size"]
        self.self_attn = Attention(c)
        self.input_layernorm = RMSNorm(d, c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(d, c["rms_norm_eps"])
        self.mlp = (MLP(d, c["intermediate_size"]) if i < c["first_k_dense_replace"]
                    else MoE(c, held))

    def forward(self, x, prec):
        x = x + self.self_attn(self.input_layernorm(x), prec)
        out = self.mlp(self.post_attention_layernorm(x), prec)
        if isinstance(out, tuple):
            return x + out[0], out[1]
        return x + out, None


class LM(nn.Module):
    def __init__(self, c: dict, held: range):
        super().__init__()
        d = c["hidden_size"]
        self.embed_tokens = Embedding(c["vocab_size"], d)
        self.layers = nn.ModuleList([Layer(c, i, held) for i in range(c["num_hidden_layers"])])
        self.norm = RMSNorm(d, c["rms_norm_eps"])
        self.lm_head = Linear(d, c["vocab_size"])


class Projector(nn.Module):
    def __init__(self, channels: int, d: int):
        super().__init__()
        self.pre_norm = LayerNorm(channels, 1e-5)
        self.linear_1 = Linear(4 * channels, 4 * channels, bias=True)
        self.linear_2 = Linear(4 * channels, d, bias=True)

    def forward(self, maps, prec):
        n, h, w, c = maps.shape
        x = self.pre_norm(maps).reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, (h // 2) * (w // 2), 4 * c)
        return self.linear_2(gelu(self.linear_1(x, prec)), prec)


class GlimpseVLM(nn.Module):
    """``projector`` and ``lm`` of configuration ``c`` (the published keys,
    ``channels`` of the glimpse maps and ``held``, the first and one-past-
    last routed expert held)."""

    def __init__(self, c: dict):
        super().__init__()
        held = range(*c.get("held", (0, c["n_routed_experts"])))
        self.projector = Projector(c.get("channels", 2048), c["hidden_size"])
        self.lm = LM(c, held)

    def forward(self, maps, tokens, prec=EXACT):
        """``maps`` ``(F·B, h, w, C)`` view-major, ``tokens`` ``(B, Lt)`` →
        ``(logits (B, Lt, V), [(scores, idx, load)] of each MoE layer)``."""
        b, lt = tokens.shape
        img = self.projector(maps.float(), prec)
        img = img.reshape(-1, b, img.shape[1], img.shape[2]).transpose(0, 1).reshape(
            b, -1, img.shape[-1])
        x = torch.cat([img, self.lm.embed_tokens(tokens)], dim=1)
        routing = []
        for layer in self.lm.layers:
            x, r = layer(x, prec)
            if r is not None:
                routing.append(r)
        n = img.shape[1]
        h = self.lm.norm(x[:, n - 1:n + lt - 1])
        return self.lm.lm_head(h, prec), routing


def caption_nll_sum(logits, tokens, pad_id: int):
    """Summed next-token negative log-likelihood of the real tokens."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[..., None])[..., 0]
    return (nll * (tokens != pad_id)).sum()


def balance_loss_sum(scores, idx, batch: int):
    """The report's ``Σᵢ fᵢ·Pᵢ`` of each of ``batch`` sequences, summed:
    ``fᵢ = E/(k·T)·#{t : i chosen}``, ``Pᵢ = mean_t sᵢ,ₜ/Σⱼ sⱼ,ₜ``."""
    tokens, experts = scores.shape
    t, k = tokens // batch, idx.shape[1]
    f = torch.stack([torch.bincount(idx[i * t:(i + 1) * t].flatten(), minlength=experts)
                     for i in range(batch)]).float() * (experts / (k * t))
    p = (scores / scores.sum(-1, keepdim=True)).view(batch, t, experts).mean(1)
    return (f * p).sum()


@torch.no_grad()
def balanced_bias(scores, top_k: int, iters: int = 400):
    """A correction bias under which a router's top-``k`` loads over
    ``scores`` ``(T, E)`` come out even, as a trained model's do: the sign
    rule ``b ← b + η·sign(mean load − load)`` from 0, ``η`` decaying from
    0.05 by 1% an iteration. It seeds random weights (the benchmark's
    caption cell, the card checks); training moves ``b`` by the report's
    rule (:func:`train_step`)."""
    experts = scores.shape[1]
    mean = scores.shape[0] * top_k / experts
    b = torch.zeros(experts, device=scores.device)
    for t in range(iters):
        load = torch.bincount(torch.topk(scores + b, top_k, dim=-1).indices.flatten(),
                              minlength=experts).float()
        b += 0.05 * 0.99 ** t * torch.sign(mean - load)
    return b


class AdamW:
    def __init__(self, params: dict, weight_decay: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.wd, self.b1, self.b2, self.eps = params, weight_decay, b1, b2, eps
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = p.grad
            p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def train_step(model: GlimpseVLM, opt: AdamW, maps_of, tokens, c: dict, block: int,
               prec=EXACT, on_first_update=None, outputs: list | None = None):
    """One update on ``tokens`` ``(B, Lt)``, ``block`` sequences at a time;
    ``maps_of(i, j)`` gives the view-major maps of images ``i … j−1``.
    The loss is the mean next-token loss over the batch's real caption
    tokens plus ``α``·the layers' balance losses, each the mean over the
    batch's sequences; then the clip, AdamW at ``c["lr"]`` and the bias
    rule over the batch's routing. ``outputs`` collects each block's
    logits. Returns the loss."""
    b = tokens.shape[0]
    real = (tokens != c["pad_id"]).sum()
    for p in model.parameters():
        p.grad = None
    loads, total = None, 0.0
    for i in range(0, b, block):
        j = min(b, i + block)
        logits, routing = model(maps_of(i, j), tokens[i:j], prec)
        loss = caption_nll_sum(logits, tokens[i:j], c["pad_id"]) / real
        if routing:
            loss = loss + c["balance_alpha"] * sum(
                balance_loss_sum(s, k, j - i) for s, k, _ in routing) / b
        loss.backward()
        total = total + loss.detach()
        if outputs is not None:
            outputs.append(logits.detach())
        step_loads = torch.stack([ld for _, _, ld in routing]) if routing else None
        loads = step_loads if loads is None else loads + step_loads
        del logits, routing, loss
    clip_by_global_norm([p.grad for p in opt.params.values()], c["clip_max_norm"])
    if on_first_update is not None:
        on_first_update({n: p.grad for n, p in opt.params.items()})
    opt.step(c["lr"])
    with torch.no_grad():
        moes = [layer.mlp for layer in model.lm.layers if isinstance(layer.mlp, MoE)]
        for moe, load in zip(moes, loads if loads is not None else []):
            load = load.float()
            moe.gate.e_score_correction_bias.add_(c["bias_gamma"] * torch.sign(load.mean() - load))
    return total
