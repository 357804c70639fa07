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
state): it restores the towers' parameters and, on caption files, the
vocabulary (synthetic captions are hashed: no vocabulary); Adam starts
fresh and the epochs restart at 0, as in the JAX driver. A checkpoint built
for another vocabulary size raises ``ValueError``.

``--dataset mscoco DATA`` pairs each image with its caption annotations
(``DATA/MSCOCO/cocoapi/annotations/captions_train2014.json`` over
``images/train2014``, else a ``captions*.json`` in ``DATA``, else ``DATA``'s
file names), and ``--dataset imagefolder DATA`` templates one caption per
image from its class directory (``DATA/train``, else ``DATA``). Both read the
files through a shuffled :class:`~multimodal_active_ai_tpu_torch.data.
loader.HostLoader` (``-j`` decode threads, ``--canvas-cache``), whose label
is the caption's index, and tokenize with a
:class:`~multimodal_active_ai_tpu_torch.models.text.Vocabulary` built over
the captions (capped at ``--vocab-size``), or the resumed checkpoint's,
with a warning when the captions would build another. ``-v`` prints the
loader's line after each train epoch. As in the JAX driver, the eval loop
reads the train images.

``--objective generative`` trains a captioner instead
(``train/caption_lm.py``): the frozen encoder's glimpse maps go through a
projector into image tokens, and Kimi-VL-A3B's language model (MLA, a
mixture of experts holding routed experts 0-7; its widths, or
``--lm-config``'s JSON of ``config.json`` keys and ``held`` over them)
learns the caption tokens that follow them, over a ``--vocab-size``
vocabulary, with AdamW at ``--lr``, the balance loss and the router bias
rule (``train/caption_lm.py``'s published values). It runs under bf16 autocast on a card and in float32 on the CPU, reports the
caption loss and next-token top-1 (``##Caption loss``, ``##Next-token
Top-1``) and writes ``caption_lm_checkpoint.pth.tar``, which ``--resume``
takes back.

On N GPUs it runs as N processes, one a card (``python -m
torch.distributed.run --nproc-per-node N -m ...``, or the JAX package's
``MAAI_*`` variables; ``parallel/distributed.py``): ``-b`` is the per-rank
batch, each rank reads its own shard, the InfoNCE and the retrieval span
the global batch (``train/caption_probe.py``), rank 0 alone prints and
writes checkpoints, and every rank reads the pretrained model and
``--resume``.
"""

from __future__ import annotations

import json
import os
from contextlib import closing
from itertools import islice
from time import time

import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.config import CaptionLMConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import (
    DROPOUT_STREAM, generator, print_loader_stats)
from multimodal_active_ai_tpu_torch.data.loader import HostLoader
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.data.readers import list_coco_images, list_image_folder
from multimodal_active_ai_tpu_torch.data.synthetic import SyntheticReader
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM, init_weights_
from multimodal_active_ai_tpu_torch.models.moe_lm import KIMI_VL_A3B, MoELMConfig
from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import PAD_ID, TextEncoder, Vocabulary, tokenize
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.parallel import print0
from multimodal_active_ai_tpu_torch.representation_evaluation import load_pretrained_encoder
from multimodal_active_ai_tpu_torch.train import caption_lm, caption_probe, optimizers
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt
from multimodal_active_ai_tpu_torch.utils.meters import AverageMeter

METRICS = ("loss", "i2t_top1", "i2t_top5", "t2i_top1", "t2i_top5")
LM_METRICS = ("caption_loss", "top1")


def caption_tokens(labels: torch.Tensor, vocab_size: int, max_len: int) -> torch.Tensor:
    """The synthetic reader's templated caption per label, hashed:
    ``(B, max_len)`` int64 on the labels' device."""
    rows = [tokenize(f"a synthetic picture of class {int(l)}", vocab_size, max_len)[0]
            for l in labels.tolist()]
    return torch.tensor(rows, dtype=torch.int64, device=labels.device)


def load_caption_pairs(cfg) -> tuple[list[str], list[str]]:
    """(files, captions) from the COCO caption annotations
    (``captions_train2014.json``), one pair per annotation; without them,
    each image file of ``cfg.data`` with its file name as the caption."""
    root = os.path.join(cfg.data, "MSCOCO", "cocoapi")
    ann_file = os.path.join(root, "annotations", "captions_train2014.json")
    file_root = os.path.join(root, "images", "train2014")
    if not os.path.isfile(ann_file):
        ann_file = None
        for cand in os.listdir(cfg.data):
            if cand.startswith("captions") and cand.endswith(".json"):
                ann_file = os.path.join(cfg.data, cand)
                file_root = cfg.data
                break
    if ann_file is None:
        files = list_coco_images(cfg.data)
        return files, [os.path.basename(f).replace("_", " ") for f in files]
    with open(ann_file) as f:
        ann = json.load(f)
    by_id = {im["id"]: im["file_name"] for im in ann["images"]}
    files, captions = [], []
    for a in ann["annotations"]:
        name = by_id.get(a["image_id"])
        if name:
            files.append(os.path.join(file_root, name))
            captions.append(a["caption"])
    return files, captions


_CAPTION_TEMPLATES = (
    "a photo of a {} pattern",
    "an image with {} coloring",
    "the picture shows a {} grating",
    "a synthetic {} textured sample",
)


def imagefolder_captions(labels, classes) -> list[str]:
    """One templated caption per file from its class-directory name, the
    templates rotating by file index so the vocabulary holds more than one
    word a class. Captions repeat within a class, which caps in-batch
    retrieval top-1 below 1."""
    names = [c.replace("_", " ") for c in classes]
    return [_CAPTION_TEMPLATES[i % len(_CAPTION_TEMPLATES)].format(names[l])
            for i, l in enumerate(labels)]


def caption_catalog(cfg) -> tuple[list[str], list[str]]:
    """(files, captions) of ``--dataset mscoco`` or ``imagefolder``; a
    missing data directory raises ``FileNotFoundError``."""
    if not cfg.data or not os.path.isdir(cfg.data):
        raise FileNotFoundError(f"--dataset {cfg.dataset}: no data directory at {cfg.data!r}")
    if cfg.dataset == "imagefolder":
        root = os.path.join(cfg.data, "train")
        files, labels, classes = list_image_folder(root if os.path.isdir(root) else cfg.data)
        return files, imagefolder_captions(labels, classes)
    return load_caption_pairs(cfg)


def with_tokens(reader, tokens_for):
    """``(images, tokens)`` for each ``(images, labels)`` batch of
    ``reader``; closing it closes the reader's iterator."""
    it = iter(reader)
    try:
        for images, labels in it:
            yield images, tokens_for(labels)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


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


def build_caption_lm(cfg, vocab_size: int, device: torch.device) -> GlimpseVLM:
    """The generative objective's model: Kimi-VL-A3B's language model,
    routed experts 0-7 held, with ``--lm-config``'s keys over both,
    ``vocab_size`` rows of vocabulary, behind a projector from the ``-a``
    encoder's maps; its weights from ``--seed``, made on ``device``. It
    runs under bf16 autocast on a card and in float32 on the CPU."""
    keys = {}
    if cfg.lm_config:
        with open(cfg.lm_config) as f:
            keys = json.load(f)
    lm = MoELMConfig.from_dict({**vars(KIMI_VL_A3B), "held": (0, 8), **keys,
                                "vocab_size": vocab_size})
    with torch.device(device):
        model = GlimpseVLM(lm, channels=encoder_feature_dim(cfg.arch),
                           dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    return init_weights_(model, generator(device, cfg.seed, 50_000))


def main(argv=None):
    """Returns the trained ``TrainState`` (``model`` the towers, or the
    language model with ``--objective generative``) and the run's
    vocabulary (None on synthetic data)."""
    cfg = parse_into(CaptionLMConfig, argv, prog="COCO_Captions_Probe")
    device = parallel.initialize_distributed(cfg.device)
    try:
        return train(cfg, device)
    finally:
        parallel.shutdown()


def train(cfg, device: torch.device):
    """``main``'s run on this rank's ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    encoder = SimCLRModule(arch=cfg.arch, norm_kind="bn",
                           generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    if device.type == "cuda":
        encoder = encoder.to(memory_format=torch.channels_last)
    load_pretrained_encoder(encoder, cfg.model, device)
    captions = None
    if cfg.dataset == "synthetic":
        # each shard contributes distinct rows of the global batch
        reader = SyntheticReader(cfg.batch_size, cfg.canvas_size,
                                 num_examples=cfg.num_examples or 16 * cfg.batch_size,
                                 seed=cfg.seed + 7919 * parallel.rank(), device=device)
    else:
        files, captions = caption_catalog(cfg)
        reader = HostLoader(files, list(range(len(files))), batch_size=cfg.batch_size,
                            canvas_size=cfg.canvas_size, shuffle=True, seed=cfg.seed,
                            shard_id=parallel.rank(), num_shards=parallel.world_size(),
                            num_threads=cfg.workers, cache_dir=cfg.canvas_cache or None,
                            pin_memory=device.type == "cuda")

    # a corpus vocabulary only where there are captions; synthetic captions
    # are hashed, and a resumed checkpoint's vocabulary is not kept
    # (coco_captions_probe.py:185-201 of the JAX package)
    payload, vocab = None, None
    text_vocab_size = cfg.vocab_size
    if cfg.resume and os.path.isfile(cfg.resume):
        payload = ckpt.load_checkpoint(cfg.resume)
    elif cfg.resume:
        print0(f"=> no checkpoint found at '{cfg.resume}'")
    if captions is not None:
        vocab = Vocabulary.build(captions, max_size=cfg.vocab_size, max_len=cfg.max_len)
        if payload is not None and "vocab_words_u8" in payload:
            # the saved embedding is indexed by its own word→id map: restore
            # it rather than trust the captions on disk to rebuild it
            rebuilt = vocab
            vocab = Vocabulary.from_u8(payload["vocab_words_u8"], max_len=cfg.max_len)
            print0(f"caption vocabulary: {vocab.size} entries, from the checkpoint")
            if rebuilt.words != vocab.words:
                print0("WARNING: caption corpus changed since the checkpoint was written "
                       f"({rebuilt.size} vs {vocab.size} entries); using the checkpoint's "
                       "vocabulary")
        text_vocab_size = vocab.size
        print0(f"caption vocabulary: {vocab.size} entries (cap {cfg.vocab_size}) over "
               f"{len(captions)} captions")

    generative = cfg.objective == "generative"
    if generative:
        model = build_caption_lm(cfg, text_vocab_size, device)
        state = TrainState(model, caption_lm.make_caption_lm_optimizer(model), lambda _: cfg.lr)
        if payload is not None:
            model.load_state_dict(payload["state_dict"])
            print0(f"=> resumed caption model from '{cfg.resume}' (epoch {int(payload['epoch'])})")
        train_step = caption_lm.make_caption_lm_train_step(retina_cfg, cfg.num_fixations,
                                                           PAD_ID)
        eval_step = caption_lm.make_caption_lm_eval_step(retina_cfg, cfg.num_fixations, PAD_ID)
        metrics, name = LM_METRICS, "caption_lm"
    else:
        feat_dim = encoder_feature_dim(cfg.arch) * 16 * cfg.num_fixations
        seeded = torch.Generator().manual_seed(cfg.seed + 1)
        model = caption_probe.CaptionTowers(
            feat_dim, TextEncoder(vocab_size=text_vocab_size, out_dim=128, generator=seeded),
            generator=seeded).to(device)
        state = TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                           lambda _: cfg.lr)
        if payload is not None:
            restore_towers(model, payload, cfg.num_fixations, text_vocab_size)
            print0(f"=> resumed caption probe from '{cfg.resume}' "
                   f"(epoch {int(payload['epoch'])})")
        train_step = caption_probe.make_caption_probe_train_step(
            retina_cfg, cfg.num_fixations, cfg.temperature)
        eval_step = caption_probe.make_caption_probe_eval_step(
            retina_cfg, cfg.num_fixations, cfg.temperature)
        metrics, name = METRICS, "caption_probe"
    ckpt_file = os.path.join(cfg.checkpoint_dir, f"{name}_checkpoint.pth.tar")
    best_file = os.path.join(cfg.checkpoint_dir, f"{name}_best.pth.tar")

    train_steps, eval_steps = loop_steps(cfg.test, len(reader))

    def tokens_for(labels):
        if captions is None:
            return caption_tokens(labels, cfg.vocab_size, cfg.max_len)
        return torch.tensor([vocab.encode(captions[i])[0] for i in labels.tolist()],
                            dtype=torch.int64)

    for epoch in range(cfg.epochs):
        meters = {k: AverageMeter() for k in metrics}
        losses = AverageMeter()
        gen = generator(device, cfg.seed, 30_000 + epoch)
        drop_gen = generator(device, cfg.seed, DROPOUT_STREAM + epoch)
        end = time()
        with closing(device_batches(with_tokens(reader, tokens_for), device)) as batches:
            for i, (images, tokens) in enumerate(islice(batches, train_steps)):
                m = train_step(state, encoder, images, tokens, gen,
                               **({} if generative else {"dropout_generator": drop_gen}))
                if i % cfg.print_freq == 0:
                    losses.update(float(m["loss"]))
                    synchronize(device)
                    print0(f"Epoch: [{epoch}][{i}/{len(reader)}]\tLoss {losses.val:.6f} "
                           f"({losses.avg:.6f})\tTime {(time() - end) / cfg.print_freq:.3f}")
                    end = time()
        print_loader_stats(cfg, reader, i + 1)
        reader.reset()

        gen = generator(device, cfg.seed, 40_000 + epoch)
        with closing(device_batches(with_tokens(reader, tokens_for), device)) as batches:
            for images, tokens in islice(batches, eval_steps):
                m = eval_step(state, encoder, images, tokens, gen)
                for k in meters:
                    meters[k].update(float(m[k]))
        reader.reset()
        if generative:
            print0(f"##Caption loss {meters['caption_loss'].avg}\n"
                   f"##Next-token Top-1 {meters['top1'].avg}")
        else:
            print0(f"##I2T Top-1 {meters['i2t_top1'].avg}\n##I2T Top-5 {meters['i2t_top5'].avg}\n"
                   f"##T2I Top-1 {meters['t2i_top1'].avg}\n##T2I Top-5 {meters['t2i_top5'].avg}")
        out = {"epoch": epoch + 1, "state_dict": model.state_dict(),
               "vocab_size": text_vocab_size}
        if vocab is not None:
            print0(f"##Vocab {vocab.size} OOV-rate {vocab.oov_rate:.4f}")
            out["vocab_words_u8"] = torch.from_numpy(vocab.to_u8())
        if parallel.is_main():
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
