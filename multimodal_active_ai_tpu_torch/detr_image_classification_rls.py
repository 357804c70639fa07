"""DETR + reinforcement-learned saccades (RLS) driver (PyTorch, CUDA by default).

Port of the JAX package's ``detr_image_classification_rls.py`` (reference
``DETR_Image_Classification_RLS.py``): the DETR glimpse-sequence classifier
trains while a DQN learns the saccade policy. Per batch: a sequential
ε-greedy rollout over ``num_fixs ∈ [2, max(F, 3) − 1]`` fixations (one
glimpse-sampler launch per fixation), the DETR update, one replay
transition per sample (the final consecutive glimpse pair, rewarded by the
query-mean top-1 correctness; ``--dense-replay`` pushes every pair), and
with probability 0.7 (a ``np.random.RandomState(--seed)`` coin, drawn once
the memory holds ``-dqnb`` transitions) a Bellman-Huber DQN update with
RMSprop; the target network is synced every ``--target-update-freq``
epochs. Validation runs the all-random control (``##Top-1``) and the
greedy policy (``##Policy Top-1``) on the same draws. Run it as::

    python -m multimodal_active_ai_tpu_torch.detr_image_classification_rls \\
        /tmp/ckpt/checkpoint.pth.tar --dataset synthetic --backbone ResNet50 \\
        -b 128 -f 2 --epochs 1 -t --num-examples 384 --checkpoint-dir /tmp/rls

The positional ``backbone_path`` is a SimCLR ``.pth.tar``, as for the DETR
driver. It runs on ``--device cuda`` (the default; it raises if CUDA is
absent) or ``--device cpu``. The replay memory lives on that device.

Checkpoints, in ``--checkpoint-dir``: ``detr_classifier_checkpoint.pth.tar``
and ``detr_classifier_model_best.pth.tar`` (the DETR driver's four keys;
``--resume`` takes one), and ``dqn_checkpoint.pth.tar`` with ``epoch``,
``step``, ``policy_state_dict`` and ``target_state_dict`` (BatchNorm
buffers included; ``--dqn-resume`` takes it). As in the JAX driver the DQN
file holds no RMSprop state, so ``--dqn-resume`` restarts its second moment
at 0, and the replay memory and the update coins start afresh. Like the
JAX driver it ignores ``-e`` and ``--export-torch``.

Not ported yet, and raising with the ROADMAP item: ``--dataset
imagenet/mscoco``, ``--multislice``, ``--canvas-cache``.
"""

from __future__ import annotations

import copy
import os
from time import time

import numpy as np
import torch

from multimodal_active_ai_tpu_torch.config import RLSConfig, check_ported, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import build_reader, generator
from multimodal_active_ai_tpu_torch.detr_image_classification import build_model, resume
from multimodal_active_ai_tpu_torch.device import resolve_device, synchronize
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory
from multimodal_active_ai_tpu_torch.train import detr_train, rls_train
from multimodal_active_ai_tpu_torch.train.optimizers import get_optimizer
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter, speed_line

DQN_UPDATE_PROB = 0.7    # RLS :776-788


def generators(device: torch.device, seed: int, stream: int):
    """One stream's draws: the device generator of the random fixations and
    the CPU generator of ``num_fixs`` and the ε coins."""
    return (generator(device, seed, stream),
            generator(torch.device("cpu"), seed, 500_000 + stream))


def push_rollout(memory: ReplayMemory, ro: rls_train.RolloutResult, num_fixs: int,
                 reward: torch.Tensor, dense: bool) -> None:
    """The replay push of one rollout: the final consecutive pair
    ``(g[nf−2], a[nf−1], g[nf−1], r)`` of every sample (RLS :757-769), or
    with ``dense`` every valid pair, all sharing the final reward."""
    pairs = range(1, num_fixs) if dense else (num_fixs - 1,)
    for j in pairs:
        memory.push(ro.glimpses[:, j - 1], ro.saccades[:, j], ro.glimpses[:, j], reward)


def main(argv=None):
    cfg = parse_into(RLSConfig, argv, prog="DETR_Image_Classification_RLS")
    check_ported(cfg)
    device = resolve_device(cfg.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    model, criterion, pretrained = build_model(cfg, device)

    # policy and target DQNs (RLS :417-427), RMSprop at --lr (RLS :445)
    policy = build_dqn(cfg.dqn, cfg.num_of_actions, norm_kind="bn",
                       dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
                       generator=torch.Generator().manual_seed(cfg.seed + 1)).to(device)
    if device.type == "cuda":
        policy = policy.to(memory_format=torch.channels_last)
    target = copy.deepcopy(policy)
    policy_state = TrainState(policy, get_optimizer("rmsprop", policy.parameters()),
                              lambda _: cfg.lr)
    g = retina_cfg.glimpse_size
    memory = ReplayMemory(cfg.replay_memory_capacity, (g, g, retina_cfg.num_channels),
                          seed=cfg.seed, device=device)

    train_reader = build_reader(cfg, "train", device)
    val_reader = build_reader(cfg, "val", device)
    batch = cfg.batch_size
    opt = detr_train.make_detr_optimizer(model, cfg.lr, cfg.lr_backbone, cfg.weight_decay,
                                         pretrained_backbone=pretrained)
    state = TrainState(model, opt, detr_train.step_lr(len(train_reader), cfg.lr_drop))
    train_step = rls_train.make_rls_train_step(
        criterion, retina_cfg, cfg.num_fixations, cfg.num_of_actions, cfg.eps_start,
        cfg.eps_end, cfg.eps_decay, cfg.clip_max_norm)
    dqn_update = rls_train.make_dqn_update_step(cfg.num_of_actions, cfg.gamma)
    eval_step = rls_train.make_policy_eval_step(criterion, retina_cfg, cfg.num_fixations,
                                                cfg.num_of_actions, greedy=False)
    policy_eval_step = rls_train.make_policy_eval_step(criterion, retina_cfg,
                                                       cfg.num_fixations, cfg.num_of_actions)

    ckpt_file = os.path.join(cfg.checkpoint_dir, "detr_classifier_checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, "detr_classifier_model_best.pth.tar")
    dqn_file = os.path.join(cfg.checkpoint_dir, "dqn_checkpoint.pth.tar")
    start_epoch, best_prec1 = resume(cfg, state, len(train_reader), device)
    if cfg.dqn_resume and os.path.isfile(cfg.dqn_resume):
        payload = ckpt.load_resume(cfg.dqn_resume, map_location=device)
        policy.load_state_dict(payload["policy_state_dict"])
        target.load_state_dict(payload["target_state_dict"])
        policy_state.step = int(payload["step"])
        print(f"=> resumed DQN from '{cfg.dqn_resume}' (step {policy_state.step})")
    elif cfg.dqn_resume:
        print(f"=> no DQN checkpoint found at '{cfg.dqn_resume}'")

    host_rng = np.random.RandomState(cfg.seed)
    total_time = AverageMeter()
    for epoch in range(start_epoch, cfg.epochs):
        batch_time, losses, dqn_losses = AverageMeter(), AverageMeter(), AverageMeter()
        gen, host_gen = generators(device, cfg.seed, 40_000 + epoch)
        end = time()
        for i, (images, labels) in enumerate(train_reader):
            draws = rls_train.draw_rollout(gen, host_gen, batch, cfg.num_fixations)
            m, ro, reward = train_step(state, policy, images, labels, epoch, draws)
            push_rollout(memory, ro, draws.num_fixs, reward, cfg.dense_replay)
            # the `and` draws the coin only once the memory is full enough,
            # so the coin stream is the JAX driver's
            if (len(memory) >= cfg.dqn_batch_size
                    and host_rng.uniform() < DQN_UPDATE_PROB):
                loss = dqn_update(policy_state, target, memory.sample(cfg.dqn_batch_size))
                dqn_losses.update(float(loss))
            if cfg.test and i > 10:
                break
            if i % cfg.print_freq == 0:
                losses.update(float(m["loss_ce"]), batch)
                synchronize(device)
                batch_time.update((time() - end) / cfg.print_freq)
                end = time()
                print(speed_line(epoch, i, len(train_reader), batch_time, losses, batch)
                      + f"\tDQN-Loss {dqn_losses.avg:.6f}"
                      + f"\tReward {float(m['reward_mean']):.3f}")
        train_reader.reset()
        total_time.update(batch_time.avg)

        if (epoch + 1) % cfg.target_update_freq == 0:      # RLS :590-592
            rls_train.sync_target(policy, target)

        # validation: the random control and the greedy policy on the same
        # draws, a paired same-budget comparison
        top1, top5, ptop1, ptop5 = (AverageMeter() for _ in range(4))
        vgen, vhost = generators(device, cfg.seed, 90_000 + epoch)
        for i, (images, labels) in enumerate(val_reader):
            draws = rls_train.draw_rollout(vgen, vhost, batch, cfg.num_fixations)
            m = eval_step(state, policy, images, labels, draws)
            pm = policy_eval_step(state, policy, images, labels, draws)
            for meter, value in ((top1, m["top1"]), (top5, m["top5"]),
                                 (ptop1, pm["top1"]), (ptop5, pm["top5"])):
                meter.update(float(value) * 100, batch)
            if cfg.test and i > 10:
                break
        val_reader.reset()
        prec1, prec5 = top1.avg, top5.avg

        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        ckpt.save_checkpoint({"epoch": epoch + 1, "state_dict": model.state_dict(),
                              "best_prec1": best_prec1, "optimizer": opt.state_dict()},
                             is_best, filename=ckpt_file, best_filename=best_file)
        ckpt.save_checkpoint({"epoch": epoch + 1, "step": policy_state.step,
                              "policy_state_dict": policy.state_dict(),
                              "target_state_dict": target.state_dict()},
                             False, filename=dqn_file)
        perf = batch / total_time.avg if total_time.avg else float("nan")
        print(f"##Top-1 {prec1}\n##Top-5 {prec5}\n##Policy Top-1 {ptop1.avg}\n"
              f"##Policy Top-5 {ptop5.avg}\n##Best Top-1 saved {best_prec1}\n##Perf {perf}")
        if cfg.test:
            break
    return state, policy_state


def cli() -> int:
    """Console entry point: exit 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
