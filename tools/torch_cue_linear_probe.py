#!/usr/bin/env python3
"""Is the cue-corpus label linearly decodable from glimpses at all? (port)

The port of ``tools/cue_linear_probe.py``: R random-fixation glimpse
stacks per image through the port's labeled retina (the tensors the DETR
backbone sees, ``train/detr_train.collect_glimpse_sequence``), and R more
with every fixation at the cue (``--oracle-fix``, y = 0.5), flattened and
fitted by a multinomial logistic regression on standardized features
(:func:`fit_probe`: full batch, Adam at 1e-2, plus 1e-4·‖w‖²).

Three numbers per split, against 1/C chance:
  per-fix   top-1 on single glimpses (what one fixation carries)
  img-mean  top-1 on the mean logits over the R fixations
  oracle    per-fix top-1 with every fixation at the cue

and the JAX tool's verdict, with its 0.15 margin. The random fixations
come from a generator made from ``--seed`` (the val split's from seed + 1),
as the drivers make theirs. Each batch launches the glimpse sampler twice
(the random and the oracle plan).

Usage (the leading ``none`` fills the RLS config's backbone positional; no
model is built here)::

    python3 tools/torch_cue_linear_probe.py none DATA [--fixations 3]
        [--probe-steps 400] [--oracle-fix 0.9] [-b 48] [--num-classes 4]
        [--canvas-cache DIR] [--device cpu]

The RLS driver's flags are read with ``--dataset imagenet --num-classes 4``
put first, so a flag given here wins. It runs on the card unless
``--device cpu`` is given; it imports torch, numpy and the port, never JAX
or the JAX package.
"""

from __future__ import annotations

import os
import sys
from contextlib import closing

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_active_ai_tpu_torch.config import RLSConfig, parse_into
from multimodal_active_ai_tpu_torch.contrastive_learning import build_reader, generator
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
from multimodal_active_ai_tpu_torch.device import resolve_device
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train.detr_train import collect_glimpse_sequence
from multimodal_active_ai_tpu_torch.train.optimizers import get_optimizer, set_learning_rate

MARGIN = 0.15


def collect_split(cfg, split: str, fixations: int, oracle_fix: float,
                  retina_cfg: retina.RetinaConfig, seed: int, device: torch.device):
    """Glimpse features for one split: ``(random_feats, oracle_feats,
    labels)``, numpy; the features ``(N, R, D)`` float32 flattened glimpse
    stacks (the padded last batch's rows included, as in the JAX tool)."""
    reader = build_reader(cfg, split, device)
    gen = generator(device, seed, 0)
    feats_r, feats_o, labels = [], [], []
    with closing(device_batches(reader, device)) as batches:
        for images, lab in batches:
            b = images.shape[0]
            rand, _, _ = collect_glimpse_sequence(images, retina_cfg, fixations, gen,
                                                  num_fixs=fixations)
            oracle = torch.full((b, fixations, 2), 0.5, device=device)
            oracle[..., 0] = oracle_fix       # saccades are (x, y)
            orac, _, _ = collect_glimpse_sequence(images, retina_cfg, fixations,
                                                  saccades=oracle, num_fixs=fixations)
            feats_r.append(rand.reshape(b, fixations, -1).float().cpu().numpy())
            feats_o.append(orac.reshape(b, fixations, -1).float().cpu().numpy())
            labels.append(lab.cpu().numpy())
    reader.reset()
    return np.concatenate(feats_r), np.concatenate(feats_o), np.concatenate(labels)


def probe_logits(train_x, train_y, val_x, num_classes: int, steps: int, lr: float = 1e-2,
                 device: torch.device | str = "cpu"):
    """The fitted probe's logits ``(train (N·R, C), val (M·R, C))``, numpy:
    the features standardized by the train split's per-dimension mean and
    std (+1e-6) in numpy, as the JAX tool does, then ``steps`` full-batch
    Adam updates (optax's β, ε) at ``lr`` of the mean cross-entropy plus
    1e-4·‖w‖² from zero weights, on ``device``."""
    n, r, d = train_x.shape
    mu = train_x.reshape(-1, d).mean(0)
    sd = train_x.reshape(-1, d).std(0) + 1e-6
    tx = torch.from_numpy((train_x.reshape(-1, d) - mu) / sd).to(device)
    ty = torch.from_numpy(np.repeat(train_y, r)).long().to(device)
    vx = torch.from_numpy((val_x.reshape(-1, d) - mu) / sd).to(device)
    w = torch.zeros((d, num_classes), device=device, requires_grad=True)
    b = torch.zeros((num_classes,), device=device, requires_grad=True)
    opt = get_optimizer("adam", [w, b])
    set_learning_rate(opt, lr)
    for i in range(steps):
        loss = F.cross_entropy(tx @ w + b, ty) + 1e-4 * (w ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % max(steps // 4, 1) == 0:
            print(f"    probe step {i + 1}/{steps} CE {float(loss.detach()):.4f}", flush=True)
    with torch.no_grad():
        return (tx @ w + b).cpu().numpy(), (vx @ w + b).cpu().numpy()


def fit_probe(train_x, train_y, val_x, val_y, num_classes: int, steps: int,
              lr: float = 1e-2, device: torch.device | str = "cpu"):
    """``(train per-fix, val per-fix, val img-mean)`` top-1 fractions of
    :func:`probe_logits`; ``train_x``/``val_x`` ``(N, R, D)``, each
    fixation's sample carrying its image's label."""
    r = train_x.shape[1]
    tr_logits, v_logits = probe_logits(train_x, train_y, val_x, num_classes, steps, lr, device)
    v_img = v_logits.reshape(val_x.shape[0], r, -1).mean(1)

    def top1(logits, y):
        return float((logits.argmax(-1) == y).mean())

    return (top1(tr_logits, np.repeat(train_y, r)), top1(v_logits, np.repeat(val_y, r)),
            top1(v_img, val_y))


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)

    def pop(flag, default, cast):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                sys.exit(f"cue_linear_probe: {flag} requires a value")
            try:
                v = cast(argv[i + 1])
            except ValueError:
                sys.exit(f"cue_linear_probe: invalid value for {flag}: "
                         f"{argv[i + 1]!r} (expected {cast.__name__})")
            del argv[i:i + 2]
            return v
        return default

    fixations = pop("--fixations", 3, int)
    probe_steps = pop("--probe-steps", 400, int)
    oracle_fix = pop("--oracle-fix", 0.9, float)
    cfg = parse_into(RLSConfig, ["--dataset", "imagenet", "--num-classes", "4"] + argv,
                     prog="cue_linear_probe")
    device = resolve_device(cfg.device)
    retina_cfg = retina.RetinaConfig(canvas_size=cfg.canvas_size)
    chance = 1.0 / cfg.num_classes

    print(f"== collecting glimpses: R={fixations} random fixations/image + "
          f"oracle at x={oracle_fix} ==", flush=True)
    tr_r, tr_o, tr_y = collect_split(cfg, "train", fixations, oracle_fix, retina_cfg,
                                     cfg.seed, device)
    va_r, va_o, va_y = collect_split(cfg, "val", fixations, oracle_fix, retina_cfg,
                                     cfg.seed + 1, device)
    print(f"   train {tr_r.shape[0]} imgs, val {va_r.shape[0]} imgs, "
          f"feature dim {tr_r.shape[-1]}", flush=True)

    results = {}
    for name, (tx_, vx_) in {"random-fix": (tr_r, va_r), "oracle-fix": (tr_o, va_o)}.items():
        print(f"== probe: {name} ==", flush=True)
        tr_acc, v_acc, v_img = fit_probe(tx_, tr_y, vx_, va_y, cfg.num_classes, probe_steps,
                                         device=device)
        results[name] = (tr_acc, v_acc, v_img)
        print(f"  {name}: train per-fix {tr_acc:.3f}  val per-fix {v_acc:.3f}"
              f"  val img-mean {v_img:.3f}  (chance {chance:.3f})", flush=True)

    rand_ok = results["random-fix"][2] > chance + MARGIN
    orac_ok = results["oracle-fix"][1] > chance + MARGIN
    if not orac_ok:
        print("VERDICT: cue NOT decodable even at the oracle fixation — the "
              "corpus cue does not survive the retina; redesign the corpus "
              "before any further training runs")
    elif not rand_ok:
        print("VERDICT: oracle decodes but random fixations do NOT — "
              "exploration cannot bootstrap the classifier at this cue "
              "width/visibility; widen the cue or raise the fixation budget")
    else:
        print("VERDICT: cue linearly decodable from random-fixation glimpses "
              "— signal strength is sufficient; a failure to learn in the "
              "driver is a model/optimizer problem")
    return results


if __name__ == "__main__":
    main()
