"""SimCLR-with-saccades pretraining driver (PyTorch, CUDA by default).

Port of the JAX package's ``contrastive_learning.py``: the same CLI, the same
epoch / ``-t`` / validate / checkpoint flow and the same ``Speed`` and
``##Perf`` log lines. Run it as::

    python -m multimodal_active_ai_tpu_torch.contrastive_learning \\
        --dataset synthetic --arch ResNet50 -b 128 -f 10 --canvas-size 640 \\
        --epochs 1 -t --num-examples 384 --checkpoint-dir /tmp/ckpt

It runs on ``--device cuda`` (the default; it raises if CUDA is absent) or
``--device cpu``. Checkpoints are ``checkpoint.pth.tar`` /
``model_best.pth.tar`` in ``--checkpoint-dir``; ``--resume`` takes one of
them, or a JAX package checkpoint (below).

On N GPUs it is one process per card::

    python -m torch.distributed.run --nproc-per-node N \\
        -m multimodal_active_ai_tpu_torch.contrastive_learning ...

(or the JAX package's ``MAAI_NUM_PROCESSES``/``MAAI_COORDINATOR``/
``MAAI_PROCESS_ID``; see ``parallel/distributed.py``). ``-b`` is the
per-rank batch and the global batch ``N·b``, as in the reference and the
JAX driver: each rank reads its own shard (the synthetic reader seeded per
shard), the encoder's BatchNorm is ``sync_bn``, the learning rate is scaled
by the global batch, and rank 0 alone prints and writes checkpoints; every
rank reads ``--resume``. ``--multislice`` prints the nodes × ranks layout.

``--stat-fusion pallas|gram`` takes the Bottleneck 1×1 convs' BatchNorm
statistics from the convs themselves (``models/conv_bn.py``; ``pallas`` is
the ``conv1x1_stats`` kernel on CUDA). The port's checkpoints have one
layout with or without it, so a checkpoint of the port resumes under any
``--stat-fusion`` value, optimizer state included.

``--resume`` also takes the JAX package's ``checkpoint.msgpack``: weights,
optax state (Adam/LARS moments, SGD momentum, the counts), step, epoch,
best top-1, histories and time, by the JAX driver's rules
(``contrastive_learning.py:184-220``): a file whose Bottleneck layout is
not the one the JAX driver would build from ``--arch``/``--stat-fusion``
converts its weights and starts the optimizer fresh, its schedule at 0.
The port's own checkpoint also keeps that schedule position (``count``).

``--dataset imagenet DATA`` reads an ImageNet folder (``DATA/ImageNet/ILSVRC/
Data/CLS-LOC/{train,val}``, else ``DATA/{train,val}``, else ``DATA`` itself)
and ``--dataset mscoco DATA`` a COCO one (``DATA/MSCOCO/cocoapi/images/
{train,val}2014`` with its instances annotations, else ``DATA``'s image
files), through :class:`~multimodal_active_ai_tpu_torch.data.loader.
HostLoader`: ``-j`` decode threads, batches pinned on CUDA, copied to the
card ``--device-prefetch`` batches ahead; ``--canvas-cache DIR`` keeps the
decoded canvases for later epochs and runs (the JAX package's cache format).
``-v`` prints the loader's line (decoder, produce and wait ms a batch,
decodes, cache hits) after each train epoch.

``--stat-fusion pallas`` is single-device, as in the JAX driver: at world >
1 it raises the JAX driver's refusal (``gram`` works at any world size).
"""

from __future__ import annotations

import os
from contextlib import closing
from time import time

import numpy as np
import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.config import ContrastiveConfig, parse_into
from multimodal_active_ai_tpu_torch.data.loader import HostLoader
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.data.readers import list_coco_images, list_image_folder
from multimodal_active_ai_tpu_torch.data.synthetic import SyntheticReader
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models import norm
from multimodal_active_ai_tpu_torch.models.norm import refuse_multi_device
from multimodal_active_ai_tpu_torch.models.resnet import Bottleneck
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import collectives, print0
from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter, perf_line, speed_line
from multimodal_active_ai_tpu_torch.utils.plotting import plot_training_stats


# the dropout stream of an epoch's train loop is DROPOUT_STREAM + epoch in
# the DETR, RLS and caption drivers (no driver draws another stream there)
DROPOUT_STREAM = 60_000


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """The driver's draws for one stream (an epoch's train or val loop, or
    its dropout)."""
    return torch.Generator(device=device).manual_seed(seed * 100_003 + stream)


def build_reader(cfg, split: str, device: torch.device, shard_id: int = 0,
                 num_shards: int = 1):
    """The train or val reader (pipe1/pipe3, ``Contrastive_Learning.py:289-409``)
    of any driver config, for shard ``shard_id`` of ``num_shards`` (a
    rank's): the synthetic reader, made on ``device`` (labels in the
    config's ``num_classes``, 1000 for SimCLR) and seeded per shard, or a
    :class:`~multimodal_active_ai_tpu_torch.data.loader.HostLoader` over
    the shard's contiguous slice of the ``mscoco`` or ``imagenet`` folder at
    ``cfg.data``, the JAX driver's layouts and fallbacks, pinned when
    ``device`` is CUDA. A missing data directory raises
    ``FileNotFoundError``."""
    bs = cfg.batch_size
    if cfg.dataset == "synthetic":
        n = cfg.num_examples or 64 * bs
        if split != "train":
            n = max(n // 10, bs)
        # each shard contributes distinct rows of the global batch
        return SyntheticReader(bs, cfg.canvas_size, num_examples=n,
                               num_classes=getattr(cfg, "num_classes", 1000),
                               seed=cfg.seed + (0 if split == "train" else 1) + 7919 * shard_id,
                               device=device)
    if not cfg.data or not os.path.isdir(cfg.data):
        raise FileNotFoundError(f"--dataset {cfg.dataset}: no data directory at {cfg.data!r}")
    if cfg.dataset == "mscoco":
        sub = "train2014" if split == "train" else "val2014"
        file_root = os.path.join(cfg.data, "MSCOCO", "cocoapi", "images", sub)
        ann = os.path.join(cfg.data, "MSCOCO", "cocoapi", "annotations", f"instances_{sub}.json")
        if not os.path.isdir(file_root):
            file_root, ann = cfg.data, None
        files, labels = list_coco_images(file_root, ann), None
    else:   # imagenet
        sub = "train" if split == "train" else "val"
        file_root = os.path.join(cfg.data, "ImageNet", "ILSVRC", "Data", "CLS-LOC", sub)
        if not os.path.isdir(file_root):
            file_root = os.path.join(cfg.data, sub) if os.path.isdir(
                os.path.join(cfg.data, sub)) else cfg.data
        files, labels, _ = list_image_folder(file_root)
    return HostLoader(files, labels, batch_size=bs, canvas_size=cfg.canvas_size,
                      shard_id=shard_id, num_shards=num_shards,
                      seed=cfg.seed, num_threads=cfg.workers,
                      cache_dir=cfg.canvas_cache or None, pin_memory=device.type == "cuda")


def epoch_examples(reader) -> int:
    """The examples an epoch trains on, for the LR schedule: a loader's
    padded ``shard_size``, as in the JAX drivers, else the synthetic
    reader's ``num_examples``."""
    return getattr(reader, "shard_size", None) or reader.num_examples


def print_loader_stats(cfg, reader, steps: int) -> None:
    """Under ``-v``, rank 0's lines for the ``steps`` train steps of the
    epoch just run: a file reader's, and with several ranks the
    collectives' calls and MB a step and ``sync_bn``'s calls a step by
    route (their counters then restart)."""
    if not cfg.verbose:
        return
    if isinstance(reader, HostLoader):
        print0(reader.stats_line())
    if parallel.world_size() > 1:
        print0(collectives.stats_line(steps))
        print0(norm.sync_bn_line(steps))
        collectives.reset_counts()
        norm.reset_sync_bn_counts()


def resume_jax(cfg, payload: dict, model: SimCLRModule, opt) -> int:
    """Load a JAX SimCLR checkpoint's weights, and its optax state where the
    JAX driver would carry it: when the file's Bottleneck layout is the one
    the JAX driver builds from ``--arch``/``--stat-fusion`` (fused iff
    ``--stat-fusion`` is set and the arch has Bottlenecks). Otherwise the
    optimizer starts fresh and its schedule restarts at 0 (the JAX driver's
    fresh optax count) while ``step`` carries on. Returns the schedule
    count."""
    want_fused = bool(cfg.stat_fusion) and any(isinstance(m, Bottleneck)
                                               for m in model.modules())
    count = ckpt.resume_jax_simclr(payload, model, opt, cfg.optimizer, want_fused, cfg.resume)
    if count is None:
        print0("=> checkpoint layout differs from --stat-fusion; "
               "converting weights (optimizer state starts fresh)")
        return 0
    return count


def main(argv=None):
    cfg = parse_into(ContrastiveConfig, argv, prog="Contrastive_Learning")
    if not cfg.data and cfg.dataset != "synthetic":
        raise Exception("error: No data set provided")
    device = parallel.initialize_distributed(cfg.device, cfg.multislice, cfg.verbose)
    try:
        return train(cfg, device)
    finally:
        parallel.shutdown()


def train(cfg, device: torch.device):
    """``main``'s run on this rank's ``device``."""
    if cfg.stat_fusion == "pallas":
        refuse_multi_device("--stat-fusion pallas", "--stat-fusion gram")
    # float32 means float32: TF32 stays off for products and convolutions;
    # --bf16 is the fast path (autocast)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global_batch, batch = parallel.per_process_batch(cfg.batch_size)
    if cfg.verbose:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print0(f"device: {device} ({name}), global batch {global_batch} ({batch}/rank)")

    retina_cfg = retina.RetinaConfig(
        canvas_size=cfg.canvas_size,
        color_aug_prob=cfg.color_augmentation,
        grid_mask_prob=cfg.grid_mask_augmentation,
        gaussian_noise_prob=cfg.gaussian_noise_augmentation,
        brightness=cfg.brightness, contrast=cfg.contrast, hue=cfg.hue,
        saturation=cfg.saturation)

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    # sync_bn: the global batch's statistics, as plain BatchNorm under GSPMD
    norm_kind = "sync_bn" if parallel.world_size() > 1 else "bn"
    model = SimCLRModule(arch=cfg.arch, norm_kind=norm_kind, dtype=dtype,
                         stat_fusion=cfg.stat_fusion or None,
                         generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    shard = (parallel.rank(), parallel.world_size())   # this rank's shard
    train_reader = build_reader(cfg, "train", device, *shard)
    val_reader = build_reader(cfg, "val", device, *shard)
    # linear-scaled by the global batch; epoch_examples/batch steps an epoch
    sched = schedule.simclr_learning_rate(
        cfg.lr, global_batch, num_examples=epoch_examples(train_reader),
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
            print0(f"=> loading checkpoint '{cfg.resume}'")
            payload = ckpt.load_checkpoint(cfg.resume, map_location=device)
            if ckpt.is_torch_file(cfg.resume):
                model.load_state_dict(payload["state_dict"])
                opt.load_state_dict(payload["optimizer"])
                state.count = int(payload.get("count", payload["step"]))
            else:
                state.count = resume_jax(cfg, payload, model, opt)
            state.step = int(payload["step"])
            start_epoch = int(payload["epoch"])
            best_prec1 = float(payload["best_prec1"])
            loss_history, top1_acc_history, top5_acc_history = (
                [float(x) for x in np.atleast_1d(payload[k])]
                for k in ("loss_history", "top1_acc_history", "top5_acc_history"))
            total_time.load_state_dict(payload["total_time"])
            print0(f"=> loaded checkpoint '{cfg.resume}' (epoch {start_epoch})")
            print0(f"Model best precision saved was {best_prec1}")
        else:
            print0(f"=> no checkpoint found at '{cfg.resume}'")

    if cfg.plot_training_history:
        if parallel.is_main():
            out = plot_training_stats(
                loss_history, top1_acc_history, top5_acc_history,
                out_path=os.path.join(cfg.checkpoint_dir, "training_history.png"))
            if out:
                print(f"training history figure written to {out}")
        print0("loss_history:", loss_history)
        print0("top1_acc_history:", top1_acc_history)
        print0("top5_acc_history:", top5_acc_history)
        hours = int(total_time.sum / 3600)
        minutes = int((total_time.sum % 3600) / 60)
        seconds = int((total_time.sum % 3600) % 60)
        print0(f"The total training time was {hours} hours {minutes} minutes "
               f"and {seconds} seconds")
        return state

    # the epoch-end save runs on a background thread while the next epoch
    # trains (the reference blocks on torch.save, Contrastive_Learning.py:
    # 517-530); it is on disk before the export and before the driver returns
    saver = ckpt.AsyncCheckpointer()
    try:
        epoch = start_epoch - 1
        for epoch in range(start_epoch, cfg.epochs):
            # ---- train (reference train(), Contrastive_Learning.py:577-740) ----
            batch_time = AverageMeter()
            losses = AverageMeter()
            nbatches = len(train_reader)
            gen = generator(device, cfg.seed, epoch)
            end = time()
            # the copy of batch i+1 overlaps step i; closing() stops the
            # transfer thread and the loader's producer on the -t break
            with closing(device_batches(train_reader, device, cfg.device_prefetch)) as batches:
                for i, (images, _labels) in enumerate(batches):
                    last_loss = train_step(state, images, gen)
                    if cfg.test and i > 10:
                        break
                    if i % cfg.print_freq == 0:
                        losses.update(float(last_loss[-1]), global_batch)
                        synchronize(device)
                        batch_time.update((time() - end) / cfg.print_freq)
                        end = time()
                        print0(speed_line(epoch, i, nbatches, batch_time, losses, global_batch))
            loss_history.append(losses.avg)
            total_time.update(batch_time.avg)
            print_loader_stats(cfg, train_reader, i + 1)
            train_reader.reset()

            # ---- validate (reference validate(), :751-904) ----
            # -t still validates and checkpoints within the single epoch
            top1 = AverageMeter()
            top5 = AverageMeter()
            val_gen = generator(device, cfg.seed, 10_000 + epoch)
            with closing(device_batches(val_reader, device)) as batches:
                for i, (images, _labels) in enumerate(batches):
                    m = eval_step(state, images, val_gen)
                    top1.update(float(m["top1"]), global_batch)
                    top5.update(float(m["top5"]), global_batch)
                    if cfg.test and i > 10:
                        break
            val_reader.reset()
            prec1, prec5 = top1.avg, top5.avg
            top1_acc_history.append(prec1)
            top5_acc_history.append(prec5)

            print0(f"From validation we have prec1 is {prec1} while best_prec1 "
                   f"is {best_prec1}")
            is_best = prec1 > best_prec1
            best_prec1 = max(prec1, best_prec1)
            if parallel.is_main():
                saver.save({
                    "epoch": epoch + 1,
                    "step": state.step,
                    "count": state.count,
                    "state_dict": model.state_dict(),
                    "best_prec1": best_prec1,
                    "optimizer": opt.state_dict(),
                    "loss_history": [float(x) for x in loss_history],
                    "top1_acc_history": [float(x) for x in top1_acc_history],
                    "top5_acc_history": [float(x) for x in top5_acc_history],
                    "total_time": total_time.state_dict(),
                }, is_best, filename=ckpt_file, best_filename=best_file)
            print0(perf_line(prec1, prec5, best_prec1, global_batch, total_time.avg))
            if cfg.test:
                break
    finally:
        saver.wait()

    if cfg.export_torch and parallel.is_main():
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
        print0(f"=> exported reference-layout checkpoint to '{cfg.export_torch}'")

    return state


def cli() -> int:
    """Console entry point: exit 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
