"""The generative caption step: a language model trained on caption tokens
that follow the glimpses' image tokens, as a VLM's supervised fine-tuning
trains it on its vision tower's tokens.

One step on a uint8 ``(B, S, S, 3)`` batch and ``(B, Lt)`` caption ids:

* the retina's draws (or the caller's ``fix_yx``) and the frozen encoder's
  glimpse maps (``eval_probe.frozen_feature_maps``: one glimpse sampler
  launch over the ``F·B`` plan, the encoder in eval mode under
  ``no_grad``);
* the model's forward (:class:`~multimodal_active_ai_tpu_torch.models.
  glimpse_vlm.GlimpseVLM`, under autocast in its dtype);
* the loss: next-token cross-entropy over the caption's real tokens plus
  ``α·Σ_layers L_bal``, DeepSeek-V3's sequence-wise balance loss of each
  MoE layer over every routed expert (``models/moe.sequence_balance_loss``);
* backward, the gradient averaged over ranks, the global-norm clip,
  AdamW at the schedule's rate;
* then each MoE layer's router bias by the sign rule over the step's
  routing (``models/moe.update_bias``; the loads summed over ranks), with
  no gradient.

The previous step's gradients are dropped before the forward, so the
forward does not hold them. The step returns device scalars; nothing in
it waits for the device but the MoE layers' reads of their group sizes.
"""

from __future__ import annotations

import torch

from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM, caption_loss
from multimodal_active_ai_tpu_torch.models.moe import MoE, sequence_balance_loss, update_bias
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import all_reduce_sum, average_gradients
from multimodal_active_ai_tpu_torch.train.detr_train import clip_by_global_norm_
from multimodal_active_ai_tpu_torch.train.eval_probe import frozen_feature_maps
from multimodal_active_ai_tpu_torch.train.optimizers import get_optimizer
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.profiling import span


def make_caption_lm_optimizer(model: torch.nn.Module,
                              weight_decay: float = 0.1) -> torch.optim.AdamW:
    """The port's AdamW over every parameter; on a card its fused form,
    which keeps no temporary the size of the parameters."""
    device = next(model.parameters()).device
    return get_optimizer("adamw", model.parameters(), weight_decay=weight_decay,
                         fused=device.type == "cuda")


def moe_layers(model: GlimpseVLM) -> list[MoE]:
    return [m for m in model.modules() if isinstance(m, MoE)]


def make_caption_lm_eval_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                              pad_id: int):
    """The caption loss and next-token top-1 over the batch's real caption
    tokens, no update: ``step(state, encoder, images, tokens,
    generator=None, fix_yx=None) -> {"caption_loss", "top1"}`` (device
    scalars)."""

    @torch.no_grad()
    def step(state: TrainState, encoder: torch.nn.Module, images: torch.Tensor,
             tokens: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        with span("trainers.eval_step"):
            maps = frozen_feature_maps(encoder, images, retina_cfg, num_fixations, generator,
                                       fix_yx)
            model = state.model
            model.eval()
            logits, _ = model(maps, tokens)
            with span("trainers.loss"):
                ce = caption_loss(logits, tokens, pad_id)
            with span("trainers.metrics"):
                keep = tokens != pad_id
                top1 = ((logits.argmax(-1) == tokens) & keep).sum() / keep.sum()
                return mean_across_replicas({"caption_loss": ce, "top1": top1})

    return step


def make_caption_lm_train_step(retina_cfg: retina.RetinaConfig, num_fixations: int,
                               pad_id: int, clip_max_norm: float = 1.0,
                               balance_alpha: float = 1e-4, bias_gamma: float = 1e-3):
    """Returns ``step(state, encoder, images, tokens, generator=None,
    fix_yx=None) -> {"loss", "caption_loss", "balance_loss"}`` (device
    scalars; ``balance_loss`` before α); ``state.model`` is the
    :class:`GlimpseVLM`, ``encoder`` the frozen glimpse encoder."""

    def step(state: TrainState, encoder: torch.nn.Module, images: torch.Tensor,
             tokens: torch.Tensor, generator: torch.Generator | None = None,
             fix_yx: torch.Tensor | None = None) -> dict:
        with span("trainers.step", state.step):
            model, opt = state.model, state.optimizer
            opt.zero_grad(set_to_none=True)
            maps = frozen_feature_maps(encoder, images, retina_cfg, num_fixations, generator,
                                       fix_yx)
            model.train()
            logits, routing = model(maps, tokens)
            with span("trainers.loss"):
                ce = caption_loss(logits, tokens, pad_id)
                bal = torch.stack([sequence_balance_loss(r, tokens.shape[0])
                                   for r in routing]).sum() if routing else ce.new_zeros(())
                loss = ce + balance_alpha * bal
            with span("trainers.backward"):
                loss.backward()
            with span("trainers.update"):
                average_gradients(model.parameters())
                with span("trainers.clip"):
                    clip_by_global_norm_(model.parameters(), clip_max_norm)
                scheduled_update(state)
                for layer, r in zip(moe_layers(model), routing):
                    update_bias(layer.gate, all_reduce_sum(r.load), bias_gamma)
            with span("trainers.metrics"):
                return mean_across_replicas({"loss": loss.detach(), "caption_loss": ce.detach(),
                                             "balance_loss": bal.detach()})

    return step
