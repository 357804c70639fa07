"""SimCLR-with-saccades pretraining driver (PyTorch, CUDA by default).

Port of the JAX package's ``contrastive_learning.py``: the same CLI, the same
epoch / ``-t`` / validate / checkpoint flow and the same ``Speed`` and
``##Perf`` log lines. Run it as::

    python -m multimodal_active_ai_tpu_torch.contrastive_learning \\
        --dataset synthetic --arch ResNet50 -b 128 -f 10 --canvas-size 640 \\
        --epochs 1 -t --num-examples 384 --checkpoint-dir /tmp/ckpt

It runs on ``--device cuda`` (the default; it raises if CUDA is absent) or
``--device cpu``. Single process: ``-b`` is the whole batch. Checkpoints are
``checkpoint.pth.tar`` / ``model_best.pth.tar`` in ``--checkpoint-dir``;
``--resume`` takes one of them.

``--stat-fusion pallas|gram`` takes the Bottleneck 1×1 convs' BatchNorm
statistics from the convs themselves (``models/conv_bn.py``; ``pallas`` is
the ``conv1x1_stats`` kernel on CUDA). The port's checkpoints have one
layout with or without it, so a checkpoint resumes under any
``--stat-fusion`` value, optimizer state included: no conversion, unlike
the JAX driver's cross-layout resume (``contrastive_learning.py:189-201``).

Not ported yet, and raising with the ROADMAP item: ``--dataset
imagenet/mscoco`` (the file readers and an image decoder), ``--multislice``
(multi-GPU), ``--canvas-cache``.
"""

from __future__ import annotations

import os
from time import time

import torch

from multimodal_active_ai_tpu_torch.config import ContrastiveConfig, check_ported, parse_into
from multimodal_active_ai_tpu_torch.data.synthetic import SyntheticReader
from multimodal_active_ai_tpu_torch.device import resolve_device, synchronize
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter, perf_line, speed_line


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """The driver's draws for one stream (an epoch's train or val loop)."""
    return torch.Generator(device=device).manual_seed(seed * 100_003 + stream)


def build_reader(cfg, split: str, device: torch.device):
    """The synthetic train/val readers (pipe1/pipe3 equivalents) of any
    driver config; labels lie in the config's ``num_classes`` (1000 for
    SimCLR, which has none)."""
    bs = cfg.batch_size
    n = cfg.num_examples or 64 * bs
    if split != "train":
        n = max(n // 10, bs)
    return SyntheticReader(bs, cfg.canvas_size, num_examples=n,
                           num_classes=getattr(cfg, "num_classes", 1000),
                           seed=cfg.seed + (0 if split == "train" else 1),
                           device=device)


def main(argv=None):
    cfg = parse_into(ContrastiveConfig, argv, prog="Contrastive_Learning")
    if not cfg.data and cfg.dataset != "synthetic":
        raise Exception("error: No data set provided")
    check_ported(cfg)
    device = resolve_device(cfg.device)
    # float32 means float32: TF32 stays off for products and convolutions;
    # --bf16 is the fast path (autocast)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.verbose:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"device: {device} ({name}), batch {cfg.batch_size}")

    retina_cfg = retina.RetinaConfig(
        canvas_size=cfg.canvas_size,
        color_aug_prob=cfg.color_augmentation,
        grid_mask_prob=cfg.grid_mask_augmentation,
        gaussian_noise_prob=cfg.gaussian_noise_augmentation,
        brightness=cfg.brightness, contrast=cfg.contrast, hue=cfg.hue,
        saturation=cfg.saturation)

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    model = SimCLRModule(arch=cfg.arch, norm_kind="bn", dtype=dtype,
                         stat_fusion=cfg.stat_fusion or None,
                         generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    train_reader = build_reader(cfg, "train", device)
    val_reader = build_reader(cfg, "val", device)
    batch = cfg.batch_size
    sched = schedule.simclr_learning_rate(
        cfg.lr, batch, num_examples=train_reader.num_examples,
        batch_size=batch, warmup_epochs=cfg.warmup_epochs,
        train_epochs=cfg.epochs, scaling=cfg.lrs)
    opt = optimizers.get_optimizer(cfg.optimizer, model.parameters(),
                                   cfg.momentum, cfg.weight_decay)
    state = simclr_train.TrainState(model, opt, sched)
    train_step = simclr_train.make_train_step(retina_cfg, cfg.num_fixations,
                                              cfg.temperature)
    eval_step = simclr_train.make_eval_step(retina_cfg, cfg.temperature)

    best_prec1 = 0.0
    total_time = AverageMeter()
    loss_history: list = []
    top1_acc_history: list = []
    top5_acc_history: list = []
    start_epoch = cfg.start_epoch
    ckpt_file = os.path.join(cfg.checkpoint_dir, "checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, "model_best.pth.tar")

    if cfg.resume:
        if os.path.isfile(cfg.resume):
            print(f"=> loading checkpoint '{cfg.resume}'")
            payload = ckpt.load_resume(cfg.resume, map_location=device)
            model.load_state_dict(payload["state_dict"])
            opt.load_state_dict(payload["optimizer"])
            state.step = int(payload["step"])
            start_epoch = int(payload["epoch"])
            best_prec1 = float(payload["best_prec1"])
            loss_history = list(payload["loss_history"])
            top1_acc_history = list(payload["top1_acc_history"])
            top5_acc_history = list(payload["top5_acc_history"])
            total_time.load_state_dict(payload["total_time"])
            print(f"=> loaded checkpoint '{cfg.resume}' (epoch {start_epoch})")
            print(f"Model best precision saved was {best_prec1}")
        else:
            print(f"=> no checkpoint found at '{cfg.resume}'")

    if cfg.plot_training_history:
        print("training-history figure: not ported (ROADMAP: the rest); "
              "printing the histories")
        print("loss_history:", loss_history)
        print("top1_acc_history:", top1_acc_history)
        print("top5_acc_history:", top5_acc_history)
        hours = int(total_time.sum / 3600)
        minutes = int((total_time.sum % 3600) / 60)
        seconds = int((total_time.sum % 3600) % 60)
        print(f"The total training time was {hours} hours {minutes} minutes "
              f"and {seconds} seconds")
        return state

    epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.epochs):
        # ---- train (reference train(), Contrastive_Learning.py:577-740) ----
        batch_time = AverageMeter()
        losses = AverageMeter()
        nbatches = len(train_reader)
        gen = generator(device, cfg.seed, epoch)
        end = time()
        for i, (images, _labels) in enumerate(train_reader):
            last_loss = train_step(state, images, gen)
            if cfg.test and i > 10:
                break
            if i % cfg.print_freq == 0:
                losses.update(float(last_loss[-1]), batch)
                synchronize(device)
                batch_time.update((time() - end) / cfg.print_freq)
                end = time()
                print(speed_line(epoch, i, nbatches, batch_time, losses, batch))
        loss_history.append(losses.avg)
        total_time.update(batch_time.avg)
        train_reader.reset()

        # ---- validate (reference validate(), :751-904) ----
        # -t still validates and checkpoints within the single epoch
        top1 = AverageMeter()
        top5 = AverageMeter()
        val_gen = generator(device, cfg.seed, 10_000 + epoch)
        for i, (images, _labels) in enumerate(val_reader):
            m = eval_step(state, images, val_gen)
            top1.update(float(m["top1"]), batch)
            top5.update(float(m["top5"]), batch)
            if cfg.test and i > 10:
                break
        val_reader.reset()
        prec1, prec5 = top1.avg, top5.avg
        top1_acc_history.append(prec1)
        top5_acc_history.append(prec5)

        print(f"From validation we have prec1 is {prec1} while best_prec1 "
              f"is {best_prec1}")
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        ckpt.save_checkpoint({
            "epoch": epoch + 1,
            "step": state.step,
            "state_dict": model.state_dict(),
            "best_prec1": best_prec1,
            "optimizer": opt.state_dict(),
            "loss_history": [float(x) for x in loss_history],
            "top1_acc_history": [float(x) for x in top1_acc_history],
            "top5_acc_history": [float(x) for x in top5_acc_history],
            "total_time": total_time.state_dict(),
        }, is_best, filename=ckpt_file, best_filename=best_file)
        print(perf_line(prec1, prec5, best_prec1, batch, total_time.avg))
        if cfg.test:
            break

    if cfg.export_torch:
        # the model's state_dict already is the reference .pth.tar layout
        ckpt.save_checkpoint({
            "epoch": epoch + 1,
            "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
            "best_prec1": best_prec1,
            "optimizer": None,
            "loss_history": [float(x) for x in loss_history],
            "top1_acc_history": [float(x) for x in top1_acc_history],
            "top5_acc_history": [float(x) for x in top5_acc_history],
            "total_time": total_time.sum,
        }, False, filename=cfg.export_torch)
        print(f"=> exported reference-layout checkpoint to '{cfg.export_torch}'")

    return state


def cli() -> int:
    """Console entry point: exit 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
