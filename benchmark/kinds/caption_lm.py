"""A generative glimpse captioner on Kimi-VL-A3B's language model, as
``coco_captions_probe.py --objective generative`` trains it.

The program: the frozen foveated ResNet (``models/simclr.SimCLRModule``
with frozen BatchNorm, as DETR's backbone, in the configuration's dtype)
through ``train/eval_probe.frozen_feature_maps``, the projector and the
language model (``models/glimpse_vlm.GlimpseVLM``: MLA, a mixture of
experts holding experts ``0 … n_routed_experts−1`` of the published count,
a vocabulary slice of ``vocab_size`` rows), ``train/caption_lm``'s AdamW
and train step (balance loss, clip, AdamW, router bias rule). Each step is
handed its fixations (this rank's rows of the global batch's view-major
draws) and a pool batch's images and caption ids.

The reference (``benchmark/reference/mla_moe.py`` in float32, its glimpse
maps from ``reference/retina`` and a frozen ``reference/resnet``) takes the
same weights, draws and captions and runs the batch in blocks of
``reference_block`` sequences, accumulating the gradient. The weights are
drawn a tensor at a time from one generator seeded from ``--seed`` (one
draw of every parameter at once would need a second copy of the model),
each clamped at ±2 and scaled by its std; the encoder's frozen BatchNorm
statistics are those of its own inputs, as DETR's (``calibrate_frozen``),
and each MoE layer's router bias balances its loads on the seed's own
sequences, as a trained model's does (``balance_router``): a random router
sends every token to the few experts that its hidden states' common
direction favours, which is no deployment's traffic.
"""

from __future__ import annotations

import math

import torch

from benchmark import flops, traffic
from benchmark.compare import Readings
from benchmark.kinds.base import Kind
from benchmark.reference import mla_moe, retina
from benchmark.reference.resnet import ResNet, calibrate_frozen

PAD = 0


class Captioner(mla_moe.GlimpseVLM):
    """The reference: the frozen encoder (``encoder``) beside the
    projector and the language model."""

    def __init__(self, c: dict):
        super().__init__(c)
        e = c["encoder"]
        self.encoder = ResNet(e["block"], e["layers"], 3 * len(c["retina"]["crop_sizes"]),
                              frozen=True, residual_gamma=e["residual_gamma"])


def lm_keys(c: dict) -> dict:
    """The reference's and the program's model keys: the router spans the
    published count of routed experts, the layer holds the first
    ``n_routed_experts`` of them."""
    e = c["encoder"]
    return dict(c, n_routed_experts=c["published"]["n_routed_experts"],
                held=(0, c["n_routed_experts"]),
                channels=512 * (4 if e["block"] == "bottleneck" else 1))


class CaptionLM(Kind):
    reference_model = Captioner

    # --- inputs ------------------------------------------------------------

    def captions(self, k, rank: int, n: int | None = None) -> torch.Tensor:
        """Pool batch ``k``'s caption ids of rank ``rank``: ``(n, Lt)`` (``n``
        the batch unless given),
        lengths ``min(hi, lo + ⌊Exp⌋)`` with median ``2·lo`` (an exponential
        of median ``lo``), ids Zipf(``zipf``) over ``1 … vocab−1`` (id 1 the
        most frequent), right-padded with id 0."""
        m, dev, n = self.mix, self.device, n or self.batch
        gen = traffic.generator(dev, self.seed, "captions", k, rank)
        lo, hi, lt = m["caption_min"], m["caption_max"], m["text_positions"]
        e = -torch.log1p(-torch.rand(n, generator=gen, device=dev)) * (lo / math.log(2))
        length = torch.clamp(lo + e.floor().long(), max=hi)
        rank_p = torch.arange(1, self.cfg["vocab_size"], device=dev, dtype=torch.float64)
        p = rank_p ** -m["zipf"]
        ids = torch.multinomial((p / p.sum()).float(), n * lt, replacement=True,
                                generator=gen).view(n, lt) + 1
        return torch.where(torch.arange(lt, device=dev) < length[:, None], ids, PAD)

    def draws(self, i: int) -> torch.Tensor:
        """Step ``i``'s fixations of the global batch, view-major: ``(F,
        B_global, 2)`` (y, x) ~ U[0, 1)²."""
        return torch.rand((self.fixations, self.global_batch, 2), device=self.device,
                          generator=traffic.generator(self.device, self.seed, "fixations", i))

    # --- the program -------------------------------------------------------

    def build_program(self):
        from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM
        from multimodal_active_ai_tpu_torch.models.moe_lm import MoELMConfig
        from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
        from multimodal_active_ai_tpu_torch.ops import retina as port_retina
        from multimodal_active_ai_tpu_torch.train import caption_lm
        from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

        c = self.cfg
        keys = lm_keys(c)
        dtype = getattr(torch, c["dtype"])
        with torch.device("meta"):
            encoder = SimCLRModule(arch=c["encoder"]["arch"], norm_kind="frozen", dtype=dtype)
            model = GlimpseVLM(MoELMConfig.from_dict(keys), channels=keys["channels"],
                               dtype=dtype)
        state = self.seed_model().state_dict()
        encoder = encoder.to_empty(device=self.device)
        encoder.f.load_state_dict({k[len("encoder."):]: v for k, v in state.items()
                                   if k.startswith("encoder.")}, strict=True)
        if self.device.type == "cuda":
            encoder = encoder.to(memory_format=torch.channels_last)
        model = model.to_empty(device=self.device)
        model.load_state_dict({k: v for k, v in state.items() if not k.startswith("encoder.")},
                              strict=True)
        del state
        self.encoder = encoder
        self.state = TrainState(model, caption_lm.make_caption_lm_optimizer(
            model, c["weight_decay"]), lambda _: c["lr"])
        self.train_module = caption_lm
        self._loss = caption_lm.caption_loss
        if self.fault == "half_loss":
            caption_lm.caption_loss = lambda logits, tokens, pad: self._loss(
                logits[: len(logits) // 2], tokens[: len(tokens) // 2], pad)
        self.fn = caption_lm.make_caption_lm_train_step(
            self.port_retina_cfg(port_retina), self.fixations, PAD, c["clip_max_norm"],
            c["balance_alpha"], c["bias_gamma"])
        self.tokens = [self.captions(k, self.rank) for k in range(self.mix["pool"])]

    def seed_model(self) -> Captioner:
        """The seed's weights on the device, the encoder's frozen BatchNorm
        statistics from ``bn_calibration_images`` canvases of the seed, one
        glimpse each."""
        c = self.cfg
        with torch.device(self.device):
            model = Captioner(lm_keys(c))
        plan = [x for m in model.modules() if hasattr(m, "init_plan") for x in m.init_plan()]
        gen = torch.Generator(self.device).manual_seed(traffic.stream(self.seed, "weights"))
        with torch.no_grad():
            for t, std in plan:
                t.copy_(torch.randn(t.shape, generator=gen, device=self.device)
                        .clamp_(-2.0, 2.0).mul_(std))
        r, n = c["retina"], c["encoder"]["bn_calibration_images"]
        images = traffic.images(self.seed, "bn-calibration", 0, n, self.canvas, self.device)
        fix = torch.rand((n, 2), device=self.device,
                         generator=traffic.generator(self.device, self.seed, "bn-calibration"))
        g = retina.glimpses(retina.build_pyramid(images, retina.mip_levels(
            r["crop_sizes"], r["glimpse_size"]).values()), retina.labeled_params(fix, self.canvas),
            self.canvas, r["glimpse_size"], r["crop_sizes"])
        calibrate_frozen(model.encoder, g)
        self.balance_router(model)
        return model

    def balance_router(self, model: Captioner, iters: int = 400) -> None:
        """Each MoE layer's correction bias set as a trained model's is, so
        that the layer's top-k loads come out even: on ``router_calibration``
        sequences of the seed (canvases, fixations and captions drawn as the
        traffic's), in layer order, the DeepSeek-V3 sign rule ``b ← b +
        η·sign(mean load − load)`` run on the layer's own scores with ``η``
        decaying from 0.05 by 1% an iteration."""
        c, r = self.cfg, self.cfg["retina"]
        n = c["router_calibration"]
        images = traffic.images(self.seed, "router-calibration", 0, n, self.canvas, self.device)
        fix = torch.rand((self.fixations * n, 2), device=self.device,
                         generator=traffic.generator(self.device, self.seed, "router-calibration"))
        tokens = self.captions("router-calibration", 0, n)

        from multimodal_active_ai_tpu_torch.reference.mla_moe import balanced_bias

        def solve(gate, args):
            with torch.no_grad():
                gate.e_score_correction_bias.copy_(balanced_bias(
                    torch.sigmoid(args[0] @ gate.weight.T), gate.top_k, iters))

        hooks = [m.register_forward_pre_hook(solve) for m in model.modules()
                 if isinstance(m, mla_moe.Gate)]
        with torch.no_grad():
            g = retina.glimpses(retina.build_pyramid(images, retina.mip_levels(
                r["crop_sizes"], r["glimpse_size"]).values()),
                retina.labeled_params(fix, self.canvas), self.canvas, r["glimpse_size"],
                r["crop_sizes"])
            model(model.encoder(g).permute(0, 2, 3, 1), tokens)
        for h in hooks:
            h.remove()

    def local_fix(self, i: int, n: int) -> torch.Tensor:
        f = self.draws(i)
        return traffic.rows(f.transpose(0, 1), self.rank, self.world)[:n].transpose(0, 1) \
            .reshape(-1, 2)

    def step(self, i: int):
        n = self.batch // 2 if self.half else self.batch
        k = i % len(self.pool)
        return self.fn(self.state, self.encoder, self.pool[k][:n], self.tokens[k][:n],
                       fix_yx=self.local_fix(i, n))

    @staticmethod
    def losses(out) -> torch.Tensor:
        return out["loss"].reshape(1)

    @staticmethod
    def output(out) -> torch.Tensor:
        return out[0]

    def flops_per_step(self) -> int:
        return step_flops(self.cfg, self.mix, self.global_batch)

    def b1_bytes(self, i: int) -> list[int]:
        r = self.cfg["retina"]
        p = retina.labeled_params(self.local_fix(i, self.batch), self.canvas)
        return [flops.b1_bytes(p, self.batch, self.canvas, r["glimpse_size"], r["crop_sizes"])]

    def free(self):
        super().free()
        self.encoder = self.tokens = None
        if getattr(self, "_loss", None) is not None:
            self.train_module.caption_loss = self._loss

    # --- the reference -----------------------------------------------------

    def reference(self, prec, steps: int) -> Readings:
        """The reference's readings over the first ``steps`` steps of the
        global batch: the first step's logits (its blocks put back
        together), the losses, the first update's clipped gradients and
        each parameter's change."""
        c, r = self.cfg, self.cfg["retina"]
        model = self.seed_model()
        enc = model.encoder
        named = {n: p for n, p in model.named_parameters() if not n.startswith("encoder.")}
        opt = mla_moe.AdamW(named, c["weight_decay"])
        factors = retina.mip_levels(r["crop_sizes"], r["glimpse_size"]).values()
        grads, vecs, outs, losses = {}, {}, [], []

        def first(g):
            vecs.update({n: t.detach().float().flatten().cpu() for n, t in g.items()})
            grads.update({n: float(v.double().norm()) for n, v in vecs.items()})

        step_cfg = dict(c, pad_id=PAD)
        for i in range(steps):
            k = i % self.mix["pool"]
            images = self.global_images(i)
            tokens = torch.cat([self.captions(k, rk) for rk in range(self.world)])
            fix = self.draws(i)

            def maps_of(a, b, images=images, fix=fix):
                with torch.no_grad():
                    f = fix[:, a:b].reshape(-1, 2)
                    g = retina.glimpses(retina.build_pyramid(images[a:b], factors),
                                        retina.labeled_params(f, self.canvas), self.canvas,
                                        r["glimpse_size"], r["crop_sizes"])
                    return enc(g, prec).permute(0, 2, 3, 1)

            losses.append(mla_moe.train_step(model, opt, maps_of, tokens, step_cfg,
                                             c["reference_block"], prec,
                                             first if i == 0 else None,
                                             outs if i == 0 else None))
        out = torch.cat(outs).float().cpu()
        del opt
        for p in model.parameters():
            p.grad = None
        start = dict(self.seed_model().named_parameters())
        change = {n: float((p.detach().double() - start[n].detach().double()).norm())
                  for n, p in named.items() if n in grads}
        return Readings(out, torch.stack(losses).double().cpu().reshape(steps, -1), grads,
                        change, vecs)


def step_flops(c: dict, mix: dict, n: int) -> int:
    """One step's operations on ``n`` images, two per multiply-add, as the
    algorithm needs them: the frozen encoder forward on every glimpse; the
    projector forward and backward (no input gradient for its first layer,
    whose input is the frozen maps); the language model forward and
    backward on every position, its attention over the causal triangle,
    the held experts on the routed rows a balanced router gives them
    (``tokens·k·held/E``), the head on the caption positions."""
    e, f = c["encoder"], mix["fixations"]
    fwd_enc, _, side = flops.resnet({**c, **e}, c["retina"]["glimpse_size"])
    ch = 512 * (4 if e["block"] == "bottleneck" else 1)
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                            c["kv_lora_rank"])
    img = f * (side // 2) * (side // 2)
    lt = mix["text_positions"]
    seq = img + lt
    t = n * seq
    merged = 4 * ch
    proj1, proj2 = 2 * n * img * merged * merged, 2 * n * img * merged * d
    attn_proj = 2 * t * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + dv)
                         + h * dv * d)
    attn_core = 2 * n * (seq * (seq + 1) // 2) * h * (nope + rope + dv)
    experts = c["published"]["n_routed_experts"]
    routed_rows = t * c["num_experts_per_tok"] * c["n_routed_experts"] / experts
    width = c["moe_intermediate_size"]
    moe = (2 * t * d * experts + 3 * 2 * t * d * c["n_shared_experts"] * width
           + 3 * 2 * routed_rows * d * width)
    dense = 3 * 2 * t * d * c["intermediate_size"]
    layers, k_dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    lm = (layers * (attn_proj + attn_core) + k_dense * dense + (layers - k_dense) * moe
          + 2 * n * lt * d * c["vocab_size"])
    return int(n * f * fwd_enc + 2 * proj1 + 3 * proj2 + 3 * lm)


KIND = CaptionLM
