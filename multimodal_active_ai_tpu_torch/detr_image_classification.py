"""DETR glimpse-sequence classifier driver (PyTorch, CUDA by default).

Port of the JAX package's ``detr_image_classification.py`` (reference
``DETR_Image_Classification.py``): a DETR encoder-decoder over the features
of a sequence of glimpses at random saccades, on the SimCLR encoder with
FrozenBatchNorm, fine-tuned with AdamW (``head`` at ``--lr``, the encoder's
layer2-4 at ``--lr_backbone``, its stem and layer1 frozen), StepLR and
global-norm clipping; validation averages the logits over the queries. Run
it as::

    python -m multimodal_active_ai_tpu_torch.detr_image_classification \\
        /tmp/ckpt/checkpoint.pth.tar --dataset synthetic --backbone ResNet50 \\
        -b 128 -f 2 --epochs 1 -t --num-examples 384 --checkpoint-dir /tmp/detr

The positional ``backbone_path`` is a SimCLR ``.pth.tar`` (the port's or
the reference's) or the JAX package's SimCLR ``.msgpack``; without one the
run starts from scratch (every parameter trains at ``--lr``; use
``--backbone-norm group``, since FrozenBatchNorm with initial statistics
normalises nothing). ``--backbone-norm group`` with a checkpoint raises.
It runs on ``--device cuda`` (the default; it raises if CUDA is absent) or
``--device cpu``. Checkpoints are ``detr_classifier_checkpoint.pth.tar``
and ``detr_classifier_model_best.pth.tar`` in ``--checkpoint-dir``, in the
reference's four-key schema; ``--resume`` takes one of them (or an
``--export-torch`` file, whose optimizer state is empty), ``-e`` only
validates, and ``--export-torch`` writes the model's ``state_dict``, which
is the reference ``detr_CLA`` layout. ``--resume`` also takes the JAX
package's ``detr_classifier_checkpoint.msgpack`` (FrozenBatchNorm
backbone): params, statistics and the optax state of its AdamW groups.

``--dataset imagenet|mscoco DATA`` and ``--canvas-cache`` read image files as
the SimCLR driver does (:func:`~multimodal_active_ai_tpu_torch.
contrastive_learning.build_reader`), the train reader shuffled each epoch
(``DETR_Image_Classification.py:263``); the batches are copied to the
device as they are used, and ``-v`` prints the loader's line after each
train epoch.

On N GPUs it runs as N processes, one a card (``python -m
torch.distributed.run --nproc-per-node N -m ...``, or the JAX package's
``MAAI_*`` variables; ``parallel/distributed.py``): ``-b`` is the per-rank
batch, each rank reads its own shard, the step is the JAX step of the
global batch (``train/``), rank 0 alone prints and writes checkpoints, and
every rank reads the pretrained model and ``--resume``.
"""

from __future__ import annotations

import os
from contextlib import closing
from time import time

import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.config import DETRConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import (
    DROPOUT_STREAM, build_reader, generator, print_loader_stats)
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models import detr as detr_models
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import print0
from multimodal_active_ai_tpu_torch.train import detr_train, optimizers
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter, speed_line


def load_backbone(model: detr_models.DETR, path: str, device: torch.device) -> bool:
    """Load the SimCLR checkpoint's encoder into the DETR backbone, its
    BatchNorm statistics into the FrozenBatchNorm buffers. Returns whether
    this is a pretrained run (which decides the parameter groups)."""
    if not path or not os.path.isfile(path):
        print0(f"=> no pretrained backbone found at '{path}' - from-scratch run "
               "(full lr on all parameters)")
        return False
    print0(f"=> loading pretrained backbone '{path}'")
    payload = ckpt.load_checkpoint(path, map_location=device)
    ckpt.load_simclr_backbone(model.body, ckpt.simclr_state_dict(payload))
    print0(f"=> loaded pretrained backbone '{path}'")
    return True


def build_model(cfg, device: torch.device):
    """The config's DETR model on ``device`` (channels-last on CUDA; bf16
    autocast with ``--bf16``), its criterion, and whether the backbone came
    from ``cfg.backbone_path``."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    model, criterion = detr_models.build(cfg, num_classes=cfg.num_classes, dtype=dtype,
                                         generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, criterion, load_backbone(model, cfg.backbone_path, device)


def resume(cfg, state: TrainState, steps_per_epoch: int,
           device: torch.device) -> tuple[int, float]:
    """Restore ``--resume``'s model and optimizer state into ``state``
    (the update count from the optimizer's state, else ``epoch ·
    steps_per_epoch``); returns ``(start_epoch, best_prec1)``, the config's
    ``start_epoch`` and 0 when there is nothing to resume. A JAX package
    checkpoint brings its params, FrozenBatchNorm statistics and optax
    state (each AdamW group's moments and count), the StepLR position
    following that count."""
    if cfg.resume and os.path.isfile(cfg.resume):
        payload = ckpt.load_checkpoint(cfg.resume, map_location=device)
        if ckpt.is_torch_file(cfg.resume):
            state.model.load_state_dict(payload["state_dict"])
            if payload["optimizer"] is not None:
                state.optimizer.load_state_dict(payload["optimizer"])
            taken = optimizers.updates_taken(state.optimizer)
        else:
            taken = ckpt.resume_jax_detr(payload, state.model, state.optimizer,
                                         bool(cfg.clip_max_norm and cfg.clip_max_norm > 0),
                                         cfg.resume)
        start_epoch = int(payload["epoch"])
        state.step = start_epoch * steps_per_epoch if taken is None else taken
        state.count = state.step
        print0(f"=> resumed from '{cfg.resume}' (epoch {start_epoch}, step {state.step})")
        return start_epoch, float(payload["best_prec1"])
    if cfg.resume:
        print0(f"=> no checkpoint found at '{cfg.resume}'")
    return cfg.start_epoch, 0.0


def main(argv=None):
    cfg = parse_into(DETRConfig, argv, prog="DETR_Image_Classification")
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

    shard = (parallel.rank(), parallel.world_size())   # this rank's shard
    train_reader = build_reader(cfg, "train", device, *shard)
    val_reader = build_reader(cfg, "val", device, *shard)
    if hasattr(train_reader, "shuffle"):
        train_reader.shuffle = True     # DETR_Image_Classification.py:263
    global_batch, _ = parallel.per_process_batch(cfg.batch_size)
    opt = detr_train.make_detr_optimizer(model, cfg.lr, cfg.lr_backbone, cfg.weight_decay,
                                         pretrained_backbone=pretrained)
    state = TrainState(model, opt, detr_train.step_lr(len(train_reader), cfg.lr_drop))
    train_step = detr_train.make_detr_train_step(criterion, retina_cfg, cfg.num_fixations,
                                                 cfg.clip_max_norm)
    eval_step = detr_train.make_detr_eval_step(criterion, retina_cfg, cfg.num_fixations)

    ckpt_file = os.path.join(cfg.checkpoint_dir, "detr_classifier_checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, "detr_classifier_model_best.pth.tar")
    start_epoch, best_prec1 = resume(cfg, state, len(train_reader), device)

    def run_validation(stream: int) -> tuple[float, float]:
        top1, top5 = AverageMeter(), AverageMeter()
        gen = generator(device, cfg.seed, stream)
        with closing(device_batches(val_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                m = eval_step(state, images, labels, gen)
                top1.update(float(m["top1"]) * 100, global_batch)
                top5.update(float(m["top5"]) * 100, global_batch)
                if cfg.test and i > 10:
                    break
        val_reader.reset()
        return top1.avg, top5.avg

    if cfg.evaluate:
        prec1, prec5 = run_validation(999)
        print0(f"##Top-1 {prec1}\n##Top-5 {prec5}")
        return prec1, prec5

    total_time = AverageMeter()
    epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.epochs):
        batch_time, losses = AverageMeter(), AverageMeter()
        nbatches = len(train_reader)
        gen = generator(device, cfg.seed, 30_000 + epoch)
        drop_gen = generator(device, cfg.seed, DROPOUT_STREAM + epoch)
        end = time()
        with closing(device_batches(train_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                m = train_step(state, images, labels, gen, dropout_generator=drop_gen)
                if cfg.test and i > 10:
                    break
                if i % cfg.print_freq == 0:
                    losses.update(float(m["loss_ce"]), global_batch)
                    synchronize(device)
                    batch_time.update((time() - end) / cfg.print_freq)
                    end = time()
                    print0(speed_line(epoch, i, nbatches, batch_time, losses, global_batch))
        print_loader_stats(cfg, train_reader)
        train_reader.reset()
        total_time.update(batch_time.avg)

        prec1, prec5 = run_validation(70_000 + epoch)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        if parallel.is_main():
            ckpt.save_checkpoint({"epoch": epoch + 1, "state_dict": model.state_dict(),
                                  "best_prec1": best_prec1, "optimizer": opt.state_dict()},
                                 is_best, filename=ckpt_file, best_filename=best_file)
        perf = global_batch / total_time.avg if total_time.avg else float("nan")
        print0(f"##Top-1 {prec1}\n##Top-5 {prec5}\n##Best Top-1 saved {best_prec1}\n"
               f"##Perf {perf}")
        if cfg.test:
            break

    if cfg.export_torch and parallel.is_main():
        # the model's state_dict already is the reference detr_CLA layout
        ckpt.save_checkpoint({"epoch": epoch + 1,
                              "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                              "best_prec1": best_prec1, "optimizer": None},
                             False, filename=cfg.export_torch)
        print0(f"=> exported reference-layout checkpoint to '{cfg.export_torch}'")
    return state


def cli() -> int:
    """Console entry point: exit 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
