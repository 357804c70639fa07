"""Reinforcement-learned saccades (RLS): DETR training + DQN glimpse policy.

Port of ``multimodal_active_ai_tpu/train/rls_train.py`` (reference
``DETR_Image_Classification_RLS.py:657-849`` + ``DQN/Training.py``). While
the DETR classifier trains, a DQN learns where to look next:

* the rollout is sequential: one mip pyramid per batch (``matmul`` mode;
  the ``fused`` and ``canvas`` retinas read the images), then per fixation
  the labeled retina at a saccade that is random (fixation 0, epoch 0, or
  the ε coin) or the policy's greedy argmax on the previous glimpse, one
  glimpse-sampler launch of ``B`` plan rows each; ``num_fixs ∈ [2,
  max(F, 3) − 1]`` is drawn once per batch and masks positions ≥
  ``num_fixs``; the policy runs in eval mode and without gradient, so a
  rollout never moves its BatchNorm statistics;
* the RLS train step updates the DETR head on the rollout (the optimizer
  chain of ``detr_train``; its dropout from ``draws.dropout``) and
  returns the per-sample reward, top-1 correctness of the query-mean
  logits of that step's train-mode forward;
* the DQN update is the Bellman-Huber loss on a replay batch, the policy in
  train mode (its BatchNorm statistics move), the target in eval mode,
  every gradient clamped to ±1, then RMSprop; :func:`sync_target` copies
  the parameters and the BatchNorm buffers.

Draws cross as values (:class:`RolloutDraws`): ``num_fixs`` and the
per-fixation coins are host numbers, drawn where the rollout branches on
them, so no fixation waits on the device; the random fixations are a device
tensor. Tests hand in the JAX package's draws instead. A greedy fixation
runs the policy; a random one skips it (the JAX step computes it and
discards it).

With several ranks (``parallel/``) ``num_fixs``, the coins and ε agree on
every rank by seed, the random fixations are drawn for the global batch and
each rank keeps its rows (and its own rows' reward, for its own replay
ring); the DETR gradient is averaged before the clip, the DQN's before the
±1 clamp, its ``sync_bn`` statistics are the global replay batch's, and
the metrics returned are the global batch's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimodal_active_ai_tpu_torch.objectives.dqn_loss import dqn_bellman_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import average_gradients, local_rows, world_size
from multimodal_active_ai_tpu_torch.rl.policy import eps_threshold, select_action_from_policy
from multimodal_active_ai_tpu_torch.train import detr_train
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update
from multimodal_active_ai_tpu_torch.utils.meters import mean_across_replicas
from multimodal_active_ai_tpu_torch.utils.metrics import top_k_accuracy


class RolloutResult(NamedTuple):
    glimpses: torch.Tensor   # (B, F, g, g, 12)
    saccades: torch.Tensor   # (B, F, 2) (x, y)
    mask: torch.Tensor       # (B, F) True = padded fixation


class RolloutDraws(NamedTuple):
    """The random draws of one RLS step: the rollout's, and the generator
    the train step's DETR dropout draws from (the JAX step's ``dropout``
    key; None where the DETR runs in eval mode or without dropout)."""

    num_fixs: int                 # in [2, max(F, 3) − 1]
    coins: tuple[float, ...]      # one ε coin per fixation, U[0, 1)
    random_fix: torch.Tensor      # (F, B, 2) this rank's random fixations (x, y), U[0, 1)
    dropout: torch.Generator | None = None


def draw_rollout(generator: torch.Generator, host_generator: torch.Generator,
                 batch: int, num_fixations: int,
                 dropout: torch.Generator | None = None) -> RolloutDraws:
    """``num_fixs`` and the coins from the CPU ``host_generator``, the
    random fixations of the global batch from ``generator`` on its device,
    this rank's ``batch`` rows kept; ``dropout`` is passed on. ``num_fixs``
    follows the reference's ``torch.randint(2, F)`` with its exclusive high
    (``:688,694``), pinned to 2 for F ≤ 3."""
    num_fixs = int(torch.randint(2, max(num_fixations, 3), (), generator=host_generator))
    coins = tuple(torch.rand(num_fixations, generator=host_generator).tolist())
    random_fix = torch.rand((num_fixations, batch * world_size(), 2), generator=generator,
                            device=generator.device)
    return RolloutDraws(num_fixs, coins, local_rows(random_fix, 1), dropout)


def make_rollout(retina_cfg: retina.RetinaConfig, num_fixations: int, num_of_actions: int,
                 eps_start: float, eps_end: float, eps_decay: float):
    """Policy-driven glimpse rollout (``DETR_Image_Classification_RLS.py:
    686-729``). Returns ``rollout(dqn, images, draws, epoch) ->
    RolloutResult``: fixation ``j`` is random when ``j == 0``, ``epoch ==
    0`` or ``coins[j] ≤ ε(epoch)``, else the policy's greedy action on
    glimpse ``j − 1``."""

    @torch.no_grad()
    def rollout(dqn: torch.nn.Module, images: torch.Tensor, draws: RolloutDraws,
                epoch: int) -> RolloutResult:
        batch, src = images.shape[0], images.shape[1]
        thr = eps_threshold(epoch, eps_start, eps_end, eps_decay)
        pyramid = (retina.build_pyramid(images, retina_cfg)
                   if retina_cfg.mode == "matmul" else None)
        glimpses, saccades = [], []
        for j in range(num_fixations):
            if j == 0 or epoch == 0 or draws.coins[j] <= thr:
                fix_xy = draws.random_fix[j]
            else:
                fix_xy = select_action_from_policy(dqn, glimpses[-1], num_of_actions)
            p = retina.sample_labeled_params(None, batch, src, fix_yx=fix_xy.flip(-1))
            glimpses.append(retina.apply_retina(images, p, retina_cfg, photometric=False,
                                                pyramid=pyramid))
            saccades.append(fix_xy)
        positions = torch.arange(num_fixations, device=images.device)
        mask = (positions >= draws.num_fixs)[None].expand(batch, num_fixations)
        return RolloutResult(torch.stack(glimpses, 1), torch.stack(saccades, 1), mask)

    return rollout


def make_rls_train_step(criterion, retina_cfg: retina.RetinaConfig, num_fixations: int,
                        num_of_actions: int, eps_start: float, eps_end: float,
                        eps_decay: float, clip_max_norm: float):
    """DETR update on a policy-driven rollout
    (``DETR_Image_Classification_RLS.py:731-769``). Returns ``step(state,
    dqn, images, labels, epoch, draws) -> (metrics, rollout, reward)``:
    ``metrics`` holds ``loss_ce``, ``reward_mean`` and ``grad_norm``
    (device scalars), ``reward`` is ``(B,)`` float32 on the device, and
    ``state.step`` advances by one update; the DETR's dropout draws from
    ``draws.dropout`` (needed when its rate is above 0)."""
    rollout_fn = make_rollout(retina_cfg, num_fixations, num_of_actions, eps_start, eps_end,
                              eps_decay)

    def step(state: TrainState, dqn: torch.nn.Module, images: torch.Tensor,
             labels: torch.Tensor, epoch: int, draws: RolloutDraws):
        ro = rollout_fn(dqn, images, draws, epoch)
        state.model.train()
        pred = state.model(ro.glimpses, ro.saccades, ro.mask, draws.dropout)["pred_logits"]
        loss = criterion(pred, labels)["loss_ce"]
        norm = detr_train.apply_update(state, loss, clip_max_norm)
        # the reward is the query-mean top-1 correctness of this forward,
        # before the update (RLS :751-769)
        reward = (pred.detach().mean(dim=1).argmax(dim=1) == labels).to(torch.float32)
        metrics = {"loss_ce": loss.detach(), "reward_mean": reward.mean(), "grad_norm": norm}
        return mean_across_replicas(metrics), ro, reward

    return step


def make_policy_eval_step(criterion, retina_cfg: retina.RetinaConfig, num_fixations: int,
                          num_of_actions: int, greedy: bool = True):
    """Validation rollouts (the JAX package's addition; the reference RLS
    has no validation loop): ``greedy=True`` runs the learned policy at
    ε = 0 after the random fixation 0 (``##Policy Top-1``), ``greedy=False``
    the all-random control (``##Top-1``, the rollout's epoch-0 branch).
    Called with the same draws, both see the same ``num_fixs`` and fixation
    0, a paired same-budget comparison. Returns ``step(state, dqn, images,
    labels, draws) -> {"loss_ce", "top1", "top5"}``."""
    rollout_fn = make_rollout(retina_cfg, num_fixations, num_of_actions, eps_start=0.0,
                              eps_end=0.0, eps_decay=1.0)
    rollout_epoch = 1 if greedy else 0

    def step(state: TrainState, dqn: torch.nn.Module, images: torch.Tensor,
             labels: torch.Tensor, draws: RolloutDraws) -> dict:
        ro = rollout_fn(dqn, images, draws, rollout_epoch)
        model = state.model
        model.eval()
        with torch.no_grad():
            pred = model(ro.glimpses, ro.saccades, ro.mask)["pred_logits"]
        logits = pred.mean(dim=1)
        return mean_across_replicas({"loss_ce": criterion(pred, labels)["loss_ce"],
                                     "top1": top_k_accuracy(logits, labels, 1),
                                     "top5": top_k_accuracy(logits, labels, 5)})

    return step


def make_dqn_update_step(num_of_actions: int, gamma: float):
    """``optimize_foveator`` equivalent (``DQN/Training.py:86-140``).
    Returns ``step(policy_state, target, transition) -> loss`` (a device
    scalar, the global replay batch's): the policy in train mode, the
    target in eval mode without gradient, every gradient averaged over
    ranks and clamped to ±1 elementwise (the reference's
    ``param.grad.data.clamp_(-1, 1)``), then one update of the policy's
    optimizer at ``policy_state.schedule(count)``; ``policy_state.step``
    and ``count`` advance by one."""

    def step(policy_state: TrainState, target: torch.nn.Module, transition) -> torch.Tensor:
        states, actions, next_states, rewards = transition
        policy, opt = policy_state.model, policy_state.optimizer
        policy.train()
        qx, qy = policy(states)
        target.eval()
        with torch.no_grad():
            tqx, tqy = target(next_states)
        loss = dqn_bellman_loss(qx, qy, tqx, tqy, actions, rewards, gamma, num_of_actions)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(policy.parameters())
        grads = [p.grad for p in policy.parameters() if p.grad is not None]
        torch._foreach_clamp_min_(grads, -1.0)
        torch._foreach_clamp_max_(grads, 1.0)
        scheduled_update(policy_state)
        return mean_across_replicas({"loss": loss.detach()})["loss"]

    return step


@torch.no_grad()
def sync_target(policy: torch.nn.Module, target: torch.nn.Module) -> None:
    """``target ← policy``: parameters and BatchNorm buffers
    (``DETR_Image_Classification_RLS.py:590-592``)."""
    target.load_state_dict(policy.state_dict())
