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
``--resume`` takes one, or the JAX driver's DETR msgpack, as the DETR
driver does), and ``dqn_checkpoint.pth.tar`` with ``epoch``, ``step``,
``policy_state_dict`` and ``target_state_dict`` (BatchNorm buffers
included; ``--dqn-resume`` takes it, or the JAX driver's
``dqn_checkpoint.msgpack`` with its two ``batch_stats``). As in the JAX
driver the DQN file holds no RMSprop state, so ``--dqn-resume`` restarts
its second moment at 0, and the replay memory and the update coins start
afresh. Like the
JAX driver it ignores ``-e`` and ``--export-torch``.

``--dataset imagenet|mscoco DATA`` and ``--canvas-cache`` read image files as
the DETR driver does, the train reader shuffled each epoch; ``-v`` prints
the loader's line after each train epoch.

On N GPUs it runs as N processes, one a card (``python -m
torch.distributed.run --nproc-per-node N -m ...``, or the JAX package's
``MAAI_*`` variables; ``parallel/distributed.py``): ``-b`` is the per-rank
batch, each rank reads its own shard, the step is the JAX step of the
global batch (``train/``), rank 0 alone prints and writes checkpoints, and
every rank reads the pretrained model and ``--resume``. Each rank keeps its
own rows in its own replay ring, ``-dqnb`` is the global replay batch (each
rank samples ``-dqnb / N``), the DQN's BatchNorm is ``sync_bn``, and the
update coins and ε agree on every rank by seed.
"""

from __future__ import annotations

import copy
import os
from contextlib import closing
from time import time

import numpy as np
import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.config import RLSConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import (
    DROPOUT_STREAM, build_reader, generator, print_loader_stats)
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.detr_image_classification import build_model, resume
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import print0
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
    device = parallel.initialize_distributed(cfg.device, cfg.multislice)
    try:
        return train(cfg, device)
    finally:
        parallel.shutdown()


def train(cfg, device: torch.device):
    """``main``'s run on this rank's ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    model, criterion, pretrained = build_model(cfg, device)

    # policy and target DQNs (RLS :417-427), RMSprop at --lr (RLS :445)
    # sync_bn on several ranks: the statistics of the global replay batch
    policy = build_dqn(cfg.dqn, cfg.num_of_actions,
                       norm_kind="sync_bn" if parallel.world_size() > 1 else "bn",
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

    shard = (parallel.rank(), parallel.world_size())   # this rank's shard
    train_reader = build_reader(cfg, "train", device, *shard)
    val_reader = build_reader(cfg, "val", device, *shard)
    if hasattr(train_reader, "shuffle"):
        train_reader.shuffle = True     # as the DETR driver's
    global_batch, batch = parallel.per_process_batch(cfg.batch_size)
    # -dqnb is the global Bellman batch: each rank samples its share from its
    # own ring (root detr_image_classification_rls.py:115-126)
    if cfg.dqn_batch_size % parallel.world_size():
        raise ValueError(f"-dqnb {cfg.dqn_batch_size} must divide by the "
                         f"{parallel.world_size()} processes it is sharded over")
    dqn_batch = cfg.dqn_batch_size // parallel.world_size()
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
        payload = ckpt.load_checkpoint(cfg.dqn_resume, map_location=device)
        if ckpt.is_torch_file(cfg.dqn_resume):
            policy_sd, target_sd = payload["policy_state_dict"], payload["target_state_dict"]
            policy_state.step = int(payload["step"])
        else:
            # the JAX DQN file holds no optimizer state: RMSprop starts fresh
            policy_sd, target_sd, policy_state.step = ckpt.jax_dqn_state_dicts(
                payload, cfg.dqn_resume)
        ckpt.load_converted(policy, lambda: policy_sd, cfg.dqn_resume, "DQN")
        ckpt.load_converted(target, lambda: target_sd, cfg.dqn_resume, "DQN")
        print0(f"=> resumed DQN from '{cfg.dqn_resume}' (step {policy_state.step})")
    elif cfg.dqn_resume:
        print0(f"=> no DQN checkpoint found at '{cfg.dqn_resume}'")

    host_rng = np.random.RandomState(cfg.seed)
    total_time = AverageMeter()
    for epoch in range(start_epoch, cfg.epochs):
        batch_time, losses, dqn_losses = AverageMeter(), AverageMeter(), AverageMeter()
        gen, host_gen = generators(device, cfg.seed, 40_000 + epoch)
        drop_gen = generator(device, cfg.seed, DROPOUT_STREAM + epoch)
        end = time()
        with closing(device_batches(train_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                draws = rls_train.draw_rollout(gen, host_gen, batch, cfg.num_fixations,
                                               drop_gen)
                m, ro, reward = train_step(state, policy, images, labels, epoch, draws)
                push_rollout(memory, ro, draws.num_fixs, reward, cfg.dense_replay)
                # the `and` draws the coin only once the memory is full enough,
                # so the coin stream is the JAX driver's
                if (len(memory) >= dqn_batch
                        and host_rng.uniform() < DQN_UPDATE_PROB):
                    loss = dqn_update(policy_state, target, memory.sample(dqn_batch))
                    dqn_losses.update(float(loss))
                if cfg.test and i > 10:
                    break
                if i % cfg.print_freq == 0:
                    losses.update(float(m["loss_ce"]), global_batch)
                    synchronize(device)
                    batch_time.update((time() - end) / cfg.print_freq)
                    end = time()
                    print0(speed_line(epoch, i, len(train_reader), batch_time, losses,
                                     global_batch)
                           + f"\tDQN-Loss {dqn_losses.avg:.6f}"
                           + f"\tReward {float(m['reward_mean']):.3f}")
        print_loader_stats(cfg, train_reader)
        train_reader.reset()
        total_time.update(batch_time.avg)

        if (epoch + 1) % cfg.target_update_freq == 0:      # RLS :590-592
            rls_train.sync_target(policy, target)

        # validation: the random control and the greedy policy on the same
        # draws, a paired same-budget comparison
        top1, top5, ptop1, ptop5 = (AverageMeter() for _ in range(4))
        vgen, vhost = generators(device, cfg.seed, 90_000 + epoch)
        with closing(device_batches(val_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                draws = rls_train.draw_rollout(vgen, vhost, batch, cfg.num_fixations)
                m = eval_step(state, policy, images, labels, draws)
                pm = policy_eval_step(state, policy, images, labels, draws)
                for meter, value in ((top1, m["top1"]), (top5, m["top5"]),
                                     (ptop1, pm["top1"]), (ptop5, pm["top5"])):
                    meter.update(float(value) * 100, global_batch)
                if cfg.test and i > 10:
                    break
        val_reader.reset()
        prec1, prec5 = top1.avg, top5.avg

        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        if parallel.is_main():
            ckpt.save_checkpoint({"epoch": epoch + 1, "state_dict": model.state_dict(),
                                  "best_prec1": best_prec1, "optimizer": opt.state_dict()},
                                 is_best, filename=ckpt_file, best_filename=best_file)
            ckpt.save_checkpoint({"epoch": epoch + 1, "step": policy_state.step,
                                  "policy_state_dict": policy.state_dict(),
                                  "target_state_dict": target.state_dict()},
                                 False, filename=dqn_file)
        perf = global_batch / total_time.avg if total_time.avg else float("nan")
        print0(f"##Top-1 {prec1}\n##Top-5 {prec5}\n##Policy Top-1 {ptop1.avg}\n"
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
