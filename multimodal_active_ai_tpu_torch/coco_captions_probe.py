"""Image–text caption probe driver (PyTorch, CUDA by default).

Port of the JAX package's ``coco_captions_probe.py``: a frozen pretrained
SimCLR encoder embeds ``-f`` foveated glimpses per image, a projection head
and a text transformer are trained with symmetric InfoNCE (temperature
``--temperature``, Adam at the constant ``--lr``), and image → text and
text → image retrieval top-1/top-5 are reported (``##I2T``/``##T2I``
lines, as fractions). Run it as::

    python -m multimodal_active_ai_tpu_torch.coco_captions_probe \\
        /tmp/ckpt/checkpoint.pth.tar --dataset synthetic -a ResNet50 \\
        -b 128 -f 2 -t --epochs 1 --checkpoint-dir /tmp/captions

The positional ``model`` is a SimCLR checkpoint: the port's or the
reference's ``.pth.tar``, or the JAX package's flax msgpack (either
Bottleneck layout, either BatchNorm kind); without one the encoder keeps its
random initialisation. The encoder is float32, as in the JAX driver. With
``--dataset synthetic`` each image's caption is the template ``"a synthetic
picture of class {label}"``, hashed by :func:`~multimodal_active_ai_tpu_torch.
models.text.tokenize` into ``--vocab-size`` buckets. It runs on ``--device
cuda`` (the default; it raises if CUDA is absent) or ``--device cpu``.

The checkpoint is ``caption_probe_checkpoint.pth.tar`` in
``--checkpoint-dir``: ``epoch``, ``state_dict`` (both towers), ``vocab_size``
and, when the run has a vocabulary, ``vocab_words_u8``. ``--resume`` takes
one of them or a JAX caption checkpoint (msgpack, which holds no optimizer
state): it restores the towers' parameters and the vocabulary; Adam starts
fresh and the epochs restart at 0, as in the JAX driver. A checkpoint built
for another vocabulary size raises ``ValueError``.

Not ported yet, and raising with the ROADMAP item: ``--dataset
mscoco/imagefolder`` and ``--canvas-cache`` (A4).
"""

from __future__ import annotations

import os
from itertools import islice
from time import time

import torch

from multimodal_active_ai_tpu_torch.config import CaptionProbeConfig, check_ported, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import generator
from multimodal_active_ai_tpu_torch.data.synthetic import SyntheticReader
from multimodal_active_ai_tpu_torch.device import resolve_device, synchronize
from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import TextEncoder, Vocabulary, tokenize
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.representation_evaluation import load_pretrained_encoder
from multimodal_active_ai_tpu_torch.train import caption_probe, optimizers
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter

METRICS = ("loss", "i2t_top1", "i2t_top5", "t2i_top1", "t2i_top5")


def caption_tokens(labels: torch.Tensor, vocab_size: int, max_len: int) -> torch.Tensor:
    """The synthetic reader's templated caption per label, hashed:
    ``(B, max_len)`` int64 on the labels' device."""
    rows = [tokenize(f"a synthetic picture of class {int(l)}", vocab_size, max_len)[0]
            for l in labels.tolist()]
    return torch.tensor(rows, dtype=torch.int64, device=labels.device)


def loop_steps(test: bool, batches: int) -> tuple[int, int]:
    """The train and eval steps of an epoch over ``batches`` batches: all of
    them, or with ``-t`` the JAX driver's cut (its train loop stops after
    ``i > 10``, its eval loop after ``i > 3``)."""
    return (min(batches, 12), min(batches, 5)) if test else (batches, batches)


def restore_towers(towers: caption_probe.CaptionTowers, payload: dict, num_fixations: int,
                   vocab_size: int) -> None:
    """Load a caption checkpoint's towers (the port's ``state_dict``, or the
    JAX ``{"image_head", "text"}`` params); a checkpoint whose text tower was
    built for another vocabulary size raises ``ValueError``."""
    saved = int(payload.get("vocab_size", vocab_size))
    if saved != vocab_size:
        raise ValueError(
            f"checkpoint text tower was built for a {saved}-entry vocabulary but this "
            f"run has {vocab_size}; the saved word→id mapping does not apply")
    sd = payload["state_dict"]
    if "image_head" in sd and "text" in sd:
        sd = ckpt.from_jax_caption_variables(sd, num_fixations)
    towers.load_state_dict(sd)


def main(argv=None):
    """Returns the trained ``TrainState`` (``model`` the towers) and the
    run's vocabulary (None unless the resumed checkpoint carries one)."""
    cfg = parse_into(CaptionProbeConfig, argv, prog="COCO_Captions_Probe")
    check_ported(cfg)
    device = resolve_device(cfg.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    encoder = SimCLRModule(arch=cfg.arch, norm_kind="bn",
                           generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    if device.type == "cuda":
        encoder = encoder.to(memory_format=torch.channels_last)
    load_pretrained_encoder(encoder, cfg.model, device)
    reader = SyntheticReader(cfg.batch_size, cfg.canvas_size,
                             num_examples=cfg.num_examples or 16 * cfg.batch_size,
                             seed=cfg.seed, device=device)

    payload, vocab = None, None
    if cfg.resume and os.path.isfile(cfg.resume):
        payload = ckpt.load_checkpoint(cfg.resume)
    elif cfg.resume:
        print(f"=> no checkpoint found at '{cfg.resume}'")
    if payload is not None and "vocab_words_u8" in payload:
        # the saved embedding is indexed by this word→id map: keep it with
        # the towers (synthetic captions are still hashed, as in the JAX driver)
        vocab = Vocabulary.from_u8(payload["vocab_words_u8"], max_len=cfg.max_len)
        print(f"caption vocabulary: {vocab.size} entries, from the checkpoint")

    feat_dim = encoder_feature_dim(cfg.arch) * 16 * cfg.num_fixations
    seeded = torch.Generator().manual_seed(cfg.seed + 1)
    towers = caption_probe.CaptionTowers(
        feat_dim, TextEncoder(vocab_size=cfg.vocab_size, out_dim=128, generator=seeded),
        generator=seeded).to(device)
    state = TrainState(towers, optimizers.get_optimizer("adam", towers.parameters()),
                       lambda _: cfg.lr)
    if payload is not None:
        restore_towers(towers, payload, cfg.num_fixations, cfg.vocab_size)
        print(f"=> resumed caption probe from '{cfg.resume}' (epoch {int(payload['epoch'])})")

    train_step = caption_probe.make_caption_probe_train_step(
        retina_cfg, cfg.num_fixations, cfg.temperature)
    eval_step = caption_probe.make_caption_probe_eval_step(
        retina_cfg, cfg.num_fixations, cfg.temperature)
    ckpt_file = os.path.join(cfg.checkpoint_dir, "caption_probe_checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, "caption_probe_best.pth.tar")

    train_steps, eval_steps = loop_steps(cfg.test, len(reader))

    def tokens_for(labels):
        return caption_tokens(labels, cfg.vocab_size, cfg.max_len)

    for epoch in range(cfg.epochs):
        meters = {k: AverageMeter() for k in METRICS}
        losses = AverageMeter()
        gen = generator(device, cfg.seed, 30_000 + epoch)
        end = time()
        for i, (images, labels) in enumerate(islice(reader, train_steps)):
            m = train_step(state, encoder, images, tokens_for(labels), gen)
            if i % cfg.print_freq == 0:
                losses.update(float(m["loss"]))
                synchronize(device)
                print(f"Epoch: [{epoch}][{i}/{len(reader)}]\tLoss {losses.val:.6f} "
                      f"({losses.avg:.6f})\tTime {(time() - end) / cfg.print_freq:.3f}")
                end = time()
        reader.reset()

        gen = generator(device, cfg.seed, 40_000 + epoch)
        for images, labels in islice(reader, eval_steps):
            m = eval_step(state, encoder, images, tokens_for(labels), gen)
            for k in meters:
                meters[k].update(float(m[k]))
        reader.reset()
        print(f"##I2T Top-1 {meters['i2t_top1'].avg}\n##I2T Top-5 {meters['i2t_top5'].avg}\n"
              f"##T2I Top-1 {meters['t2i_top1'].avg}\n##T2I Top-5 {meters['t2i_top5'].avg}")
        out = {"epoch": epoch + 1, "state_dict": towers.state_dict(),
               "vocab_size": cfg.vocab_size}
        if vocab is not None:
            print(f"##Vocab {vocab.size} OOV-rate {vocab.oov_rate:.4f}")
            out["vocab_words_u8"] = torch.from_numpy(vocab.to_u8())
        ckpt.save_checkpoint(out, False, filename=ckpt_file, best_filename=best_file)
        if cfg.test:
            break
    return state, vocab


def cli() -> int:
    """Console entry point: exit 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
