#!/usr/bin/env python3
"""The RLS cue-task diagnostic: a pretrained-frozen backbone against one
trained from init (port).

The port of ``tools/rls_cue_diag.py``: the production RLS train step
(``train/rls_train.make_rls_train_step``) on the same corpus with every
fixation random (ε = 1), in two arms:

  arm A  pretrained-frozen  (``detr_image_classification.load_backbone``:
         stem and layer1 frozen, FrozenBatchNorm, ``--lr_backbone`` on
         layer2-4)
  arm B  from-init          (every parameter in the optimizer at ``--lr``:
         the JAX package's fix after its queue9 run)

Each arm prints its cross-entropy every 4 steps and its first and last
4-step means; the verdict lines are the JAX tool's. One process on one
device, the DETR and the DQN in float32 as in the JAX tool; the draws come
from generators made from ``--seed``, as the RLS driver makes them; the DQN
is not updated (the step only reads it, and at ε = 1 not even that).

Usage::

    python3 tools/torch_rls_cue_diag.py BACKBONE DATA [--steps 40] [-b 16]
        [--arm both|pretrained|from-init] [--canvas-cache DIR] [--device cpu]

The RLS driver's flags are read with ``--dataset imagenet --backbone
ResNet18 --num-classes 4 -f 3 --lr 5e-4 --gamma 0.0 --num-of-actions 10``
put first, so a flag given here wins (the JAX tool appends them, so there
they win). It runs on the card unless
``--device cpu`` is given; it imports torch, numpy and the port, never JAX
or the JAX package.
"""

from __future__ import annotations

import os
import sys
from contextlib import closing

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_active_ai_tpu_torch.config import RLSConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import (
    DROPOUT_STREAM, build_reader, generator)
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.detr_image_classification import load_backbone
from multimodal_active_ai_tpu_torch.detr_image_classification_rls import generators
from multimodal_active_ai_tpu_torch.device import resolve_device
from multimodal_active_ai_tpu_torch.models import detr as detr_models
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train import detr_train, rls_train
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

DEFAULTS = ["--dataset", "imagenet", "--backbone", "ResNet18", "--num-classes", "4", "-f", "3",
            "--lr", "5e-4", "--gamma", "0.0", "--num-of-actions", "10"]


def run_arm(name: str, cfg, load_pretrained: bool, steps: int, device: torch.device):
    """``steps`` RLS train steps of one arm; returns ``(first, last, model)``:
    the mean CE of the first and of the last 4 steps, and the trained DETR."""
    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    model, criterion = detr_models.build(cfg, num_classes=cfg.num_classes, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    pretrained = load_pretrained and load_backbone(model, cfg.backbone_path, device)
    if load_pretrained and not pretrained:
        raise FileNotFoundError(f"arm {name}: no pretrained backbone at {cfg.backbone_path!r}")
    dqn = build_dqn(cfg.dqn, cfg.num_of_actions, norm_kind="bn", dtype=torch.float32,
                    generator=torch.Generator().manual_seed(cfg.seed + 1)).to(device)

    reader = build_reader(cfg, "train", device)
    if hasattr(reader, "shuffle"):
        reader.shuffle = True
    opt = detr_train.make_detr_optimizer(model, cfg.lr, cfg.lr_backbone, cfg.weight_decay,
                                         pretrained_backbone=pretrained)
    state = TrainState(model, opt, detr_train.step_lr(len(reader), cfg.lr_drop))
    # ε pinned to 1: every fixation random, the exploration phase
    train_step = rls_train.make_rls_train_step(
        criterion, retina_cfg, cfg.num_fixations, cfg.num_of_actions, 1.0, 1.0, cfg.eps_decay,
        cfg.clip_max_norm)

    print(f"== arm {name}: backbone={'pretrained' if pretrained else 'from-init'}"
          f" b={cfg.batch_size} steps={steps} ==", flush=True)
    losses, rewards = [], []
    step = epoch = 0
    while step < steps:
        gen, host_gen = generators(device, cfg.seed, 40_000 + epoch)
        drop_gen = generator(device, cfg.seed, DROPOUT_STREAM + epoch)
        with closing(device_batches(reader, device)) as batches:
            for images, labels in batches:
                draws = rls_train.draw_rollout(gen, host_gen, images.shape[0],
                                               cfg.num_fixations, drop_gen)
                m, _, _ = train_step(state, dqn, images, labels, 0, draws)
                losses.append(float(m["loss_ce"]))
                rewards.append(float(m["reward_mean"]))
                step += 1
                if step % 4 == 0:
                    k = min(4, len(losses))
                    print(f"  [{name}] step {step:3d} CE {np.mean(losses[-k:]):.4f}"
                          f" reward {np.mean(rewards[-k:]):.3f}", flush=True)
                if step >= steps:
                    break
        reader.reset()
        epoch += 1
    first = float(np.mean(losses[:4]))
    last = float(np.mean(losses[-4:]))
    print(f"== arm {name} done: CE {first:.4f} -> {last:.4f}"
          f" (delta {last - first:+.4f}), reward {np.mean(rewards[-8:]):.3f} ==", flush=True)
    return first, last, model


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    steps = 40
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        del argv[i:i + 2]
    arm = "both"
    if "--arm" in argv:
        i = argv.index("--arm")
        arm = argv[i + 1]
        if arm not in ("both", "pretrained", "from-init"):
            sys.exit(f"rls_cue_diag: --arm {arm!r} is not both, pretrained or from-init")
        del argv[i:i + 2]
    cfg = parse_into(RLSConfig, DEFAULTS + argv, prog="rls_cue_diag")
    device = resolve_device(cfg.device)
    a = (run_arm("A/pretrained", cfg, True, steps, device)[:2]
         if arm in ("both", "pretrained") else None)
    b = (run_arm("B/from-init", cfg, False, steps, device)[:2]
         if arm in ("both", "from-init") else None)
    if a:
        print(f"VERDICT: pretrained CE delta {a[1] - a[0]:+.4f}")
    if b:
        print(f"VERDICT: from-init CE delta {b[1] - b[0]:+.4f}")
    if a and b:
        if b[1] - b[0] < -0.05 and a[1] - a[0] > -0.05:
            print("VERDICT: backbone confirmed — from-init learns, "
                  "pretrained-frozen does not")
        elif a[1] - a[0] < -0.05:
            print("VERDICT: pretrained arm learns here — backbone NOT the "
                  "explanation; look at batch size / step count / curriculum")
        else:
            print("VERDICT: neither arm learns at this budget — rerun with "
                  "more steps or bigger batch before concluding")
    elif b:
        # single-arm mode: the decisive signal is CE below the uniform-prior
        # floor ln(C); a from-init delta alone includes the fall from a
        # random init to the prior
        floor = float(np.log(cfg.num_classes))
        if b[1] < floor - 0.05:
            print(f"VERDICT: backbone confirmed — from-init crosses below "
                  f"the ln({cfg.num_classes})={floor:.3f} floor")
        else:
            print(f"VERDICT: from-init reached {b[1]:.4f} vs floor "
                  f"{floor:.3f} — descended to the prior but not below it; "
                  f"inconclusive at this step budget, rerun longer")
    return {"pretrained": a, "from-init": b}


if __name__ == "__main__":
    main()
