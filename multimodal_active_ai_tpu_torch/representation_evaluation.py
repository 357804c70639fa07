"""Linear-probe representation evaluation driver (PyTorch, CUDA by default).

Port of the JAX package's ``representation_evaluation.py`` (reference
``Representation_Evaluation.py``): the SimCLR checkpoint's encoder ``f``
is loaded and frozen (eval mode, ``no_grad``), the features of
``num_fixations`` labeled glimpses per image are concatenated, and a
logistic-regression probe is trained with cross-entropy and validated
(``##Top-1`` / ``##Top-5``). Run it as::

    python -m multimodal_active_ai_tpu_torch.representation_evaluation \\
        /tmp/ckpt/checkpoint.pth.tar --dataset synthetic --arch ResNet50 \\
        -b 128 -f 2 --epochs 1 -t --num-examples 384 --checkpoint-dir /tmp/probe

The positional ``model`` is a SimCLR ``.pth.tar`` written by the port's
``contrastive_learning`` (or the reference), or a SimCLR ``.msgpack``
written by the JAX package (either Bottleneck layout, either BatchNorm
kind); ``g.*`` is dropped. Without
one the encoder keeps its random initialisation. It runs on ``--device
cuda`` (the default; it raises if CUDA is absent) or ``--device cpu``.
Checkpoints are ``classifier_checkpoint.pth.tar`` and
``classifier_model_best.pth.tar`` in ``--checkpoint-dir``, in the
reference's four-key schema (``epoch``, ``state_dict``, ``best_prec1``,
``optimizer``); ``--resume`` takes one of them (or an ``--export-torch``
file, whose optimizer state is empty, so the moments restart), ``-e`` only
validates, and ``--export-torch`` writes the probe's ``state_dict``, which
is the reference layout. ``--resume`` also takes the JAX package's
``classifier_checkpoint.msgpack``: the probe's params and its optax state
(moments and counts), the schedule following optax's count.

``--dataset imagenet|mscoco DATA`` and ``--canvas-cache`` read image files as
the SimCLR driver does (:func:`~multimodal_active_ai_tpu_torch.
contrastive_learning.build_reader`); the batches are copied to the device
as they are used, and ``-v`` prints the loader's line after each train
epoch.

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
from multimodal_active_ai_tpu_torch.config import EvalConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import (
    build_reader, epoch_examples, generator, print_loader_stats)
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import print0
from multimodal_active_ai_tpu_torch.train import eval_probe, optimizers, schedule
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter, speed_line


def load_pretrained_encoder(encoder: SimCLRModule, path: str,
                            device: torch.device) -> bool:
    """Load the encoder ``f`` of the SimCLR checkpoint at ``path`` into
    ``encoder.f`` (the projector is never used downstream,
    ``Representation_Evaluation.py:405-422``). Returns whether a
    checkpoint was loaded."""
    if not path or not os.path.isfile(path):
        print0(f"=> no checkpoint found at '{path}' (using random init)")
        return False
    print0(f"=> loading checkpoint '{path}'")
    payload = ckpt.load_checkpoint(path, map_location=device)
    encoder.f.load_state_dict(ckpt.encoder_state_dict(ckpt.simclr_state_dict(payload)))
    print0(f"=> loaded pretrained model '{path}'")
    return True


def main(argv=None):
    cfg = parse_into(EvalConfig, argv, prog="Representation_Evaluation")
    device = parallel.initialize_distributed(cfg.device, cfg.multislice)
    try:
        return train(cfg, device)
    finally:
        parallel.shutdown()


def train(cfg, device: torch.device):
    """``main``'s run on this rank's ``device``."""
    if cfg.classifier != "logistic_regression":
        raise Exception(f"error: Unknown classifier {cfg.classifier}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    encoder = SimCLRModule(arch=cfg.arch, norm_kind="bn", dtype=dtype,
                           generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    if device.type == "cuda":
        encoder = encoder.to(memory_format=torch.channels_last)
    load_pretrained_encoder(encoder, cfg.model, device)

    # LogisticRegression(C·4·4·F, num_classes) (Representation_Evaluation.py:427-439)
    feat_dim = encoder_feature_dim(cfg.arch) * 16 * cfg.num_fixations
    probe = LogisticRegression(feat_dim, cfg.num_classes,
                               generator=torch.Generator().manual_seed(cfg.seed + 1)).to(device)

    shard = (parallel.rank(), parallel.world_size())   # this rank's shard
    train_reader = build_reader(cfg, "train", device, *shard)
    val_reader = build_reader(cfg, "val", device, *shard)
    global_batch, batch = parallel.per_process_batch(cfg.batch_size)
    sched = schedule.simclr_learning_rate(
        cfg.lr, global_batch, num_examples=epoch_examples(train_reader), batch_size=batch,
        warmup_epochs=cfg.warmup_epochs, train_epochs=cfg.epochs, scaling=cfg.lrs)
    opt = optimizers.get_optimizer(cfg.optimizer, probe.parameters(), cfg.momentum,
                                   cfg.weight_decay)
    state = TrainState(probe, opt, sched)
    train_step = eval_probe.make_probe_train_step(retina_cfg, cfg.num_fixations)
    eval_step = eval_probe.make_probe_eval_step(retina_cfg, cfg.num_fixations)

    ckpt_file = os.path.join(cfg.checkpoint_dir, "classifier_checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, "classifier_model_best.pth.tar")
    best_prec1 = 0.0
    start_epoch = cfg.start_epoch
    if cfg.resume and os.path.isfile(cfg.resume):
        payload = ckpt.load_checkpoint(cfg.resume, map_location=device)
        if ckpt.is_torch_file(cfg.resume):
            probe.load_state_dict(payload["state_dict"])
            if payload["optimizer"] is not None:
                opt.load_state_dict(payload["optimizer"])
            taken = optimizers.updates_taken(opt)
        else:
            # the JAX probe's params and optax state; the schedule follows its count
            taken = ckpt.resume_jax_probe(payload, probe, opt, cfg.optimizer,
                                          cfg.num_fixations, cfg.resume)
        start_epoch = int(payload["epoch"])
        best_prec1 = float(payload["best_prec1"])
        state.step = start_epoch * len(train_reader) if taken is None else taken
        state.count = state.step
        print0(f"=> resumed classifier from '{cfg.resume}' (epoch {start_epoch}, "
               f"step {state.step})")
    elif cfg.resume:
        print0(f"=> no checkpoint found at '{cfg.resume}'")

    def run_validation(stream: int) -> tuple[float, float]:
        top1, top5 = AverageMeter(), AverageMeter()
        gen = generator(device, cfg.seed, stream)
        with closing(device_batches(val_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                m = eval_step(state, encoder, images, labels, gen)
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
        gen = generator(device, cfg.seed, 20_000 + epoch)
        end = time()
        with closing(device_batches(train_reader, device)) as batches:
            for i, (images, labels) in enumerate(batches):
                m = train_step(state, encoder, images, labels, gen)
                if cfg.test and i > 10:
                    break
                if i % cfg.print_freq == 0:
                    losses.update(float(m["loss"]), global_batch)
                    synchronize(device)
                    batch_time.update((time() - end) / cfg.print_freq)
                    end = time()
                    print0(speed_line(epoch, i, nbatches, batch_time, losses, global_batch))
        print_loader_stats(cfg, train_reader)
        train_reader.reset()
        total_time.update(batch_time.avg)

        prec1, prec5 = run_validation(50_000 + epoch)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        if parallel.is_main():
            ckpt.save_checkpoint({"epoch": epoch + 1, "state_dict": probe.state_dict(),
                                  "best_prec1": best_prec1, "optimizer": opt.state_dict()},
                                 is_best, filename=ckpt_file, best_filename=best_file)
        perf = global_batch / total_time.avg if total_time.avg else float("nan")
        print0(f"##Top-1 {prec1}\n##Top-5 {prec5}\n##Best Top-1 saved {best_prec1}\n"
               f"##Perf {perf}")
        if cfg.test:
            break

    if cfg.export_torch and parallel.is_main():
        # the probe's state_dict already is the reference layout
        ckpt.save_checkpoint({"epoch": epoch + 1,
                              "state_dict": {k: v.cpu() for k, v in probe.state_dict().items()},
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
