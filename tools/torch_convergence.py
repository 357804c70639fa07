"""Convergence cases of the PyTorch port: each of its training paths learns.

The seven cases of ``tests/test_convergence.py``, the JAX package's
convergence suite, as plain functions on the port's own step functions.
Data, widths, depths, learning rates and step counts are the JAX test's;
:data:`THRESHOLDS` holds its thresholds, and :func:`misses` applies them to
what a case returns. Each case is ``case(device, seed=0, ...) -> dict`` of
the numbers the JAX test asserts on, plus the per-step losses under
``"losses"``.

``tests/test_torch_port_convergence.py`` runs the cases on the CPU (slow);
``chip_smoke.py`` phase 3l runs them on the card, where the check counts.

Random draws come from explicit ``torch.Generator``s made from ``seed``, as
the drivers make them: the weights from CPU generators, the retina's and
the rollouts' draws from one on ``device`` (the ε coins and ``num_fixs`` of
the RLS rollout from a CPU one). So a case's numbers are a function of the
seed and the device type. The data is the JAX test's, from seeded numpy.

:func:`simclr_curve` is the port's side of the SimCLR loss-curve parity
(``tools/torch_loss_curve_parity.py``): the loop of
``tools/loss_curve_parity.py`` on a pre-augmented glimpse stream
(:func:`view_stream`, a copy of that tool's).

This module imports torch and the port only, never JAX or the JAX package.
As a script it runs cases at several seeds and prints each one's numbers
and the thresholds it met or missed (cuDNN deterministic on the card, as in
phase 3l):

    python3 tools/torch_convergence.py [--device cpu] [--cases simclr,rls] [--seeds 0,1,2]
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_active_ai_tpu_torch.device import resolve_device
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import (
    PAD_ID,
    GlimpseCaptioner,
    TextEncoder,
    Vocabulary,
)
from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory
from multimodal_active_ai_tpu_torch.train import caption_probe, detr_train, eval_probe, rls_train
from multimodal_active_ai_tpu_torch.train import schedule, simclr_train
from multimodal_active_ai_tpu_torch.train.optimizers import get_optimizer
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update

GLIMPSE_CFG = dict(canvas_size=64, crop_sizes=(40, 24, 10, 30), supersample=2)
GLIMPSE, CHANNELS = 30, 12
# case 1's retina: photometric augmentations off, so views differ by crop,
# rotation and flip only and the hue that identifies an image survives
SIMCLR_CFG = retina.RetinaConfig(color_aug_prob=0.0, grid_mask_prob=0.0,
                                 gaussian_noise_prob=0.0, **GLIMPSE_CFG)

# Each bound is a number or ``(key, scale, offset)``: ``scale·r[key] + offset``.
THRESHOLDS = {
    "simclr": [("final_top1", ">=", 0.6),
               ("final_top1", ">=", ("initial_top1", 1.0, 0.25)),
               ("final_loss", "<=", ("first_loss", 1.0, -1.5))],
    "probe": [("top1", ">=", 0.8)],
    "detr": [("top1", ">=", 0.95),
             ("final_loss_ce", "<", 0.05)],
    "dqn": [("greedy", ">=", ("random", 2.0, 0.0))],
    "caption": [("i2t_top1", ">=", 0.5),
                ("t2i_top1", ">=", 0.5),
                ("final_loss", "<=", ("first_loss", 1.0, -1.5))],
    "captioner": [("final_ce", "<", 0.2),
                  ("token_match", ">=", 0.95)],
    "rls": [("policy", ">=", ("random", 1.0, 0.2)),
            ("policy", ">=", 0.85)],
}


def keys_read(case: str) -> set[str]:
    """The result keys :data:`THRESHOLDS` reads for ``case``."""
    keys = set()
    for key, _, bound in THRESHOLDS[case]:
        keys.add(key)
        if isinstance(bound, tuple):
            keys.add(bound[0])
    return keys


def misses(case: str, result: dict) -> list[str]:
    """The thresholds of ``case`` that ``result`` misses, each as text
    (empty when it meets them all; a value that is not finite misses)."""
    out = []
    for key, op, bound in THRESHOLDS[case]:
        if isinstance(bound, tuple):
            other, scale, offset = bound
            limit = scale * result[other] + offset
            what = f"{scale:g}*{other}{offset:+g}"
        else:
            limit, what = bound, f"{bound:g}"
        value = result[key]
        ok = {">=": value >= limit, "<=": value <= limit, "<": value < limit}[op]
        if not (ok and math.isfinite(value)):
            out.append(f"{key} {value:.4f} {op} {what} = {limit:.4f} missed")
    return out


# ---------------------------------------------------------------------------
# data: copies of the JAX test's numpy helpers


def structured_images(n, size=64, n_classes=None, seed=0):
    """n distinct images; class = dominant hue, instance = grating
    frequency/orientation/phase. Returns (uint8 (n,size,size,3), labels).
    A copy of ``tests/test_convergence.py:structured_images``."""
    ncls = n_classes or n
    r = np.random.RandomState(seed)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    labels = np.zeros((n,), np.int32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        c = i % ncls
        labels[i] = c
        hue = (c / ncls) * 2 * np.pi
        base = np.array([np.cos(hue), np.cos(hue - 2 * np.pi / 3),
                         np.cos(hue + 2 * np.pi / 3)]) * 0.5 + 0.5
        freq = 2 + (i * 7) % 5
        ang = i * 2.399
        grating = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx * np.cos(ang) + yy * np.sin(ang))
            + r.uniform(0, 2 * np.pi))
        img = base[None, None, :] * (0.35 + 0.65 * grating[..., None])
        imgs[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return imgs, labels


def stripe_images(n_classes=4, size=64):
    """The RLS case's images: class information only in a vertical stripe
    at the right edge (hue = class, texture = instance), two instances a
    class. Returns (uint8 (2·n_classes, size, size, 3), int32 labels). The
    JAX test builds them inline (``tests/test_convergence.py:400-417``)."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    bg = np.repeat((0.5 + 0.25 * np.sin(2 * np.pi * 3 * (xx + yy)))[..., None],
                   3, axis=2)
    imgs, labels = [], []
    for c in range(n_classes):
        hue = c / n_classes * 2 * np.pi
        col = np.array([np.cos(hue), np.cos(hue - 2 * np.pi / 3),
                        np.cos(hue + 2 * np.pi / 3)]) * 0.5 + 0.5
        for k in range(2):
            im = bg.copy()
            tex = 0.6 + 0.4 * np.sin(2 * np.pi * 4 * yy[:, 56:64] + k * 1.7)
            im[:, 56:64] = col[None, None, :] * tex[..., None]
            imgs.append(np.clip(im * 255, 0, 255).astype(np.uint8))
            labels.append(c)
    return np.stack(imgs), np.asarray(labels, np.int32)


def view_stream(seed, steps, fixations, batch):
    """The shared pre-augmented glimpse stream: (F+1) views per step. A copy
    of ``tools/loss_curve_parity.py:view_stream``."""
    def views_for(step):
        r = np.random.RandomState(seed + step)
        return r.uniform(0.0, 255.0, (fixations + 1, batch, GLIMPSE, GLIMPSE,
                                      CHANNELS)).astype(np.float32)
    return views_for


# ---------------------------------------------------------------------------
# helpers


def _init(seed: int) -> torch.Generator:
    """The weights' generator (on the CPU, as the drivers make it)."""
    return torch.Generator().manual_seed(seed)


def _draws(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator of draws on ``device``, one stream of ``seed`` (the
    drivers' ``seed·100003 + stream``)."""
    return torch.Generator(device=device).manual_seed(seed * 100_003 + stream)


def _place(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` on ``device``; channels-last activations on CUDA, as the
    drivers place their models."""
    model = model.to(device)
    return model.to(memory_format=torch.channels_last) if device.type == "cuda" else model


def _device_of(model: nn.Module) -> str:
    """The device type the trained model's weights are on."""
    return next(model.parameters()).device.type


def _adam(model: nn.Module, lr: float) -> TrainState:
    return TrainState(model, get_optimizer("adam", model.parameters()), lambda t: lr)


def _floats(values) -> list[float]:
    """Device scalars as floats, read back in one transfer."""
    values = list(values)
    return [float(v) for v in torch.stack(values).reshape(-1).cpu()] if values else []


def _mean(values) -> float:
    return float(torch.stack([torch.as_tensor(v) for v in values]).mean())


def _images(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# the cases, in the order of tests/test_convergence.py


def simclr_case(device="cpu", seed=0, steps=60, evals=4, arch="ResNet18", norm_kind="bn",
                stat_fusion=None) -> dict:
    """Case 1 (``test_convergence.py:64-104``): SimCLR with saccades on 32
    fixed images, F=1, Adam 1e-3, T=0.5, :data:`SIMCLR_CFG`. Contrastive
    top-1 is the mean of ``evals`` eval steps (the JAX test's 4) on the same
    draws before and after training; the first and final losses are those
    of the first and last step."""
    dev = torch.device(device)
    model = _place(SimCLRModule(arch, norm_kind=norm_kind, stat_fusion=stat_fusion,
                                generator=_init(seed)), dev)
    state = _adam(model, 1e-3)
    step = simclr_train.make_train_step(SIMCLR_CFG, num_fixations=1, temperature=0.5)
    evs = simclr_train.make_eval_step(SIMCLR_CFG, temperature=0.5)
    images = _images(structured_images(32)[0], dev)

    def contrastive_top1() -> float:
        gen = _draws(dev, seed, 1)       # the same eval draws each time
        return _mean(evs(state, images, gen)["top1"] for _ in range(evals))

    initial_top1 = contrastive_top1()
    gen = _draws(dev, seed, 0)
    losses = _floats(step(state, images, gen)[-1] for _ in range(steps))
    return {"initial_top1": initial_top1, "final_top1": contrastive_top1(),
            "first_loss": losses[0], "final_loss": losses[-1], "losses": losses,
            "device": _device_of(model)}


def simclr_same_state(device="cpu", seed=0, steps=20, arch="ResNet50", **kinds) -> dict:
    """Case 1's configuration at ``arch`` along one trajectory of the
    ``bn`` model: before each of its ``steps`` train steps a second model,
    built with ``kinds`` (``norm_kind``, ``stat_fusion``) from the same
    init, takes the ``bn`` model's weights, BatchNorm statistics and Adam
    state and runs the same step on the same draws. Returns both models'
    per-step losses, ``"reference"`` (``bn``) and ``"candidate"``. Two
    float32 runs trained apart drift apart by more than their arithmetic
    differs: Adam turns rounding-level gradient differences into
    lr-sized updates, so from one state at a time is where two
    implementations of one step can be held to each other."""
    dev = torch.device(device)
    ref, cand = (_adam(_place(SimCLRModule(arch, generator=_init(seed), **k), dev), 1e-3)
                 for k in ({}, kinds))
    step = simclr_train.make_train_step(SIMCLR_CFG, num_fixations=1, temperature=0.5)
    images = _images(structured_images(32)[0], dev)
    gen = _draws(dev, seed, 0)
    losses = []
    for _ in range(steps):
        cand.model.load_state_dict(ref.model.state_dict())
        cand.optimizer.load_state_dict(ref.optimizer.state_dict())
        cand.step, cand.count = ref.step, ref.count
        drawn = gen.get_state()
        candidate = step(cand, images, gen)[-1]
        gen.set_state(drawn)
        losses.append((step(ref, images, gen)[-1], candidate))
    return {"reference": _floats(r for r, _ in losses),
            "candidate": _floats(c for _, c in losses), "device": _device_of(cand.model)}


def probe_case(device="cpu", seed=0, steps=30, evals=3) -> dict:
    """Case 2 (``:107-136``): a logistic probe on a frozen random-init
    ResNet18 (eval mode), 4 colour classes, F=1, Adam 1e-2; top-1 is the
    mean of ``evals`` eval steps (3)."""
    dev = torch.device(device)
    cfg = retina.RetinaConfig(**GLIMPSE_CFG)
    init = _init(seed)
    enc = _place(SimCLRModule("ResNet18", generator=init), dev)
    state = _adam(_place(LogisticRegression(512 * 16, 4, generator=init), dev), 1e-2)
    tstep = eval_probe.make_probe_train_step(cfg, 1)
    estep = eval_probe.make_probe_eval_step(cfg, 1)
    img_np, lbl_np = structured_images(32, n_classes=4, seed=3)
    images, labels = _images(img_np, dev), _images(lbl_np, dev).long()
    gen = _draws(dev, seed, 0)
    losses = _floats(tstep(state, enc, images, labels, gen)["loss"] for _ in range(steps))
    gen = _draws(dev, seed, 1)
    top1 = _mean(estep(state, enc, images, labels, gen)["top1"] for _ in range(evals))
    return {"top1": top1, "losses": losses, "device": _device_of(state.model)}


def detr_case(device="cpu", seed=0, steps=40, evals=3) -> dict:
    """Case 3 (``:139-178``): the DETR classifier (hidden 32, 1 + 1 layers,
    2 heads, 4 queries, dropout 0; AdamW 1e-3 / backbone 1e-4, the stem and
    layer1 frozen, clip 0.1) overfits 8 images of 2 classes, F=2; top-1 is
    the mean of ``evals`` eval steps (3), ``final_loss_ce`` the last train
    step's."""
    dev = torch.device(device)
    cfg = retina.RetinaConfig(**GLIMPSE_CFG)
    model = _place(DETR(backbone_arch="ResNet18", num_classes=2, num_queries=4, hidden_dim=32,
                        nheads=2, enc_layers=1, dec_layers=1, dim_feedforward=64,
                        dropout=0.0, generator=_init(seed)), dev)
    criterion = SetCriterion(num_queries=4, num_classes=2)
    opt = detr_train.make_detr_optimizer(model, lr=1e-3, lr_backbone=1e-4, weight_decay=1e-4)
    state = TrainState(model, opt, detr_train.step_lr(1, 200))
    tstep = detr_train.make_detr_train_step(criterion, cfg, 2, clip_max_norm=0.1)
    estep = detr_train.make_detr_eval_step(criterion, cfg, 2)
    img_np, lbl_np = structured_images(8, n_classes=2, seed=5)
    images, labels = _images(img_np, dev), _images(lbl_np, dev).long()
    eval_gen = _draws(dev, seed, 1)
    initial_top1 = float(estep(state, images, labels, eval_gen)["top1"])
    gen = _draws(dev, seed, 0)
    losses = _floats(tstep(state, images, labels, gen)["loss_ce"] for _ in range(steps))
    top1 = _mean(estep(state, images, labels, eval_gen)["top1"] for _ in range(evals))
    return {"initial_top1": initial_top1, "top1": top1, "final_loss_ce": losses[-1],
            "losses": losses, "device": _device_of(model)}


def dqn_case(device="cpu", seed=0, updates=60) -> dict:
    """Case 4 (``:181-232``): reward at one fixation bin (x=1, y=2 of A=4);
    ``updates`` Bellman-Huber updates (γ=0, Adam 3e-3, the target the
    initial policy) of 32 transitions from a 512-row ring of random-action
    transitions. ``greedy`` is the greedy policy's expected reward on 64 of
    the states, ``random`` the uniform policy's (0.5)."""
    dev = torch.device(device)
    a, tgt = 4, (1, 2)
    dqn = _place(build_dqn("ResNet18", num_of_actions=a, norm_kind="bn",
                           generator=_init(seed)), dev)
    target = _place(build_dqn("ResNet18", num_of_actions=a, norm_kind="bn"), dev)
    rls_train.sync_target(dqn, target)
    pstate = _adam(dqn, 3e-3)
    upd = rls_train.make_dqn_update_step(a, gamma=0.0)

    r = np.random.RandomState(0)
    n = 512
    states = r.uniform(0, 255, (n, 30, 30, 12)).astype(np.float32)
    a_idx = r.randint(0, a, (n, 2))
    rewards = (1.0 * (a_idx[:, 0] == tgt[0])
               + 1.0 * (a_idx[:, 1] == tgt[1])).astype(np.float32)
    mem = ReplayMemory(n, (30, 30, 12), seed=seed, device=dev)
    mem.push(*(torch.from_numpy(x).to(dev) for x in (
        states, a_idx.astype(np.float32) / a,
        r.uniform(0, 255, (n, 30, 30, 12)).astype(np.float32), rewards)))
    losses = _floats(upd(pstate, target, mem.sample(32)) for _ in range(updates))
    dqn.eval()
    with torch.no_grad():
        qx, qy = dqn(_images(states[:64], dev))
    hits = (1.0 * (qx.argmax(1) == tgt[0]) + 1.0 * (qy.argmax(1) == tgt[1]))
    return {"greedy": float(hits.mean()), "random": 1.0 / a + 1.0 / a, "losses": losses,
            "device": _device_of(dqn)}


CAPTION_COLORS = ("red", "green", "blue", "yellow", "pink", "teal", "olive", "navy",
                  "coral", "plum", "gold", "gray", "lime", "cyan", "rust", "jade")


def caption_case(device="cpu", seed=0, steps=200, evals=3, calibration=5) -> dict:
    """Case 5 (``:235-305``): the caption probe on 16 (image, caption)
    pairs through the corpus :class:`Vocabulary`: a frozen random ResNet18
    whose BatchNorm running statistics are first calibrated by
    ``calibration`` train-mode passes on labeled glimpses, an image head
    ``MLP(8192 → 256 → 64)`` and a 1-layer text tower (d 64, 2 heads, FFN
    128, dropout 0), symmetric InfoNCE at T=0.5, Adam 3e-3. Retrieval top-1
    both ways is the mean of ``evals`` eval steps (3)."""
    dev = torch.device(device)
    cfg = retina.RetinaConfig(**GLIMPSE_CFG)
    n = 16
    init = _init(seed)
    enc = _place(SimCLRModule("ResNet18", generator=init), dev)
    images = _images(structured_images(n)[0], dev)
    gen = _draws(dev, seed, 2)
    enc.train()
    with torch.no_grad():
        for _ in range(calibration):
            p = retina.sample_labeled_params(gen, n, images.shape[1])
            enc(retina.apply_retina(images, p, cfg, photometric=False))

    captions = [f"a {CAPTION_COLORS[i]} grating pattern number {i}" for i in range(n)]
    vocab = Vocabulary.build(captions, max_size=128, max_len=12)
    tokens = torch.tensor(np.stack([vocab.encode(c)[0] for c in captions]),
                          dtype=torch.long, device=dev)
    text = TextEncoder(vocab_size=vocab.size, d_model=64, nhead=2, num_layers=1,
                       dim_feedforward=128, out_dim=64, dropout=0.0, generator=init)
    towers = _place(caption_probe.CaptionTowers(512 * 16, text, hidden_dim=256, out_dim=64,
                                                generator=init), dev)
    state = _adam(towers, 3e-3)
    tstep = caption_probe.make_caption_probe_train_step(cfg, 1, temperature=0.5)
    estep = caption_probe.make_caption_probe_eval_step(cfg, 1, temperature=0.5)
    gen = _draws(dev, seed, 0)
    losses = _floats(tstep(state, enc, images, tokens, gen)["loss"] for _ in range(steps))
    gen = _draws(dev, seed, 1)
    metrics = [estep(state, enc, images, tokens, gen) for _ in range(evals)]
    return {"i2t_top1": _mean(m["i2t_top1"] for m in metrics),
            "t2i_top1": _mean(m["t2i_top1"] for m in metrics),
            "first_loss": losses[0], "final_loss": losses[-1], "losses": losses,
            "device": _device_of(towers)}


def captioner_case(device="cpu", seed=0, steps=150) -> dict:
    """Case 6 (``:308-362``): the glimpse captioner (d 64, 2 heads, 1
    layer, FFN 128, dropout 0) memorises 4 captions over fixed random
    glimpse memories ``(4, 3, 32)``, teacher forcing, Adam 3e-3.
    ``final_ce`` is the last step's masked cross-entropy, ``token_match``
    the share of non-pad targets the trained model's argmax reproduces."""
    dev = torch.device(device)
    captions = ["a red block on the left", "the dog chases a ball",
                "two birds over blue water", "a train arrives at night"]
    vocab = Vocabulary.build(captions, max_size=64, max_len=10)
    tokens = torch.tensor(np.stack([vocab.encode(c)[0] for c in captions]),
                          dtype=torch.long, device=dev)
    feats = torch.randn((4, 3, 32), generator=_draws(dev, seed, 0), device=dev)
    model = _place(GlimpseCaptioner(32, vocab_size=vocab.size, d_model=64, nhead=2,
                                    num_layers=1, dim_feedforward=128, dropout=0.0,
                                    generator=_init(seed)), dev)
    state = _adam(model, 3e-3)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    keep = (targets != PAD_ID).to(torch.float32)

    def step() -> torch.Tensor:
        lp = F.log_softmax(model(feats, inputs), dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
        loss = torch.sum(nll * keep) / torch.sum(keep)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        scheduled_update(state)
        return loss.detach()

    losses = _floats(step() for _ in range(steps))
    with torch.no_grad():
        pred = model(feats, inputs).argmax(-1)
    match = float(torch.sum((pred == targets) * keep) / torch.sum(keep))
    return {"first_ce": losses[0], "final_ce": losses[-1], "token_match": match,
            "losses": losses, "device": _device_of(model)}


class OracleDQN(nn.Module):
    """Q stub whose argmax is the last bin on both heads: fixation
    ``(A − 1)/A`` on both axes, the RLS case's stripe."""

    def __init__(self, num_of_actions: int):
        super().__init__()
        self.num_of_actions = num_of_actions

    def forward(self, states: torch.Tensor):
        q = torch.zeros((states.shape[0], self.num_of_actions), device=states.device)
        q[:, -1] = 1.0
        return q, q


def rls_case(device="cpu", seed=0, na=130, nb=80, evals=4, init=None, draws=None) -> dict:
    """Case 7 (``:365-499``): learned saccades beat random ones. The stripe
    images (4 classes, 8 images), A=10, F=3. Phase A: ``na`` RLS steps
    train the DETR (hidden 32, 1 + 1 layers; AdamW 5e-4 / 1e-4, clip 0.1)
    on rollouts of the :class:`OracleDQN` at ε = 0.3. Phase B: ``nb`` RLS
    steps with the real ResNet18 DQN (ε 0.9 → 0.05, decay 2 epochs of 10
    steps) push each rollout's last pair of fixations into a 2048-row
    ring, and, from 48 rows on, one Bellman-Huber update (γ=0, Adam 3e-3)
    of 48 sampled rows follows each step. As in the JAX test, phase B's
    DETR updates are discarded: each step runs on a copy of the DETR state
    (the port's step updates in place). ``policy`` and ``random`` are the
    greedy and the all-random eval top-1, each the mean of ``evals`` evals
    (4) on the same draws.

    ``init`` ``(detr_state_dict, dqn_state_dict)`` and ``draws`` (the
    ``na + nb + evals`` :class:`~rls_train.RolloutDraws` in the order the
    steps take them) replace the seed's weights and draws, so that the
    JAX test's can be fed in (``tools/torch_rls_seeds.py``)."""
    dev = torch.device(device)
    cfg = retina.RetinaConfig(**GLIMPSE_CFG)
    a, f, ncls = 10, 3, 4
    img_np, lbl_np = stripe_images(ncls)
    images, labels = _images(img_np, dev), _images(lbl_np, dev).long()
    b = int(labels.shape[0])
    model = _place(DETR(backbone_arch="ResNet18", num_classes=ncls, num_queries=4,
                        hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
                        dim_feedforward=64, dropout=0.0, generator=_init(seed)), dev)
    criterion = SetCriterion(num_queries=4, num_classes=ncls)
    opt = detr_train.make_detr_optimizer(model, lr=5e-4, lr_backbone=1e-4, weight_decay=1e-4)
    state = TrainState(model, opt, detr_train.step_lr(1, 200))
    dqn = _place(build_dqn("ResNet18", num_of_actions=a, norm_kind="bn",
                           generator=_init(seed + 1)), dev)
    if init is not None:
        model.load_state_dict(init[0])
        dqn.load_state_dict(init[1])
    target = _place(build_dqn("ResNet18", num_of_actions=a, norm_kind="bn"), dev)
    rls_train.sync_target(dqn, target)
    pstate = _adam(dqn, 3e-3)
    memory = ReplayMemory(2048, (30, 30, 12), seed=seed, device=dev)

    step_a = rls_train.make_rls_train_step(criterion, cfg, f, a, eps_start=0.3, eps_end=0.3,
                                           eps_decay=1.0, clip_max_norm=0.1)
    step_b = rls_train.make_rls_train_step(criterion, cfg, f, a, eps_start=0.9, eps_end=0.05,
                                           eps_decay=2.0, clip_max_norm=0.1)
    dqn_upd = rls_train.make_dqn_update_step(a, gamma=0.0)
    pol_eval = rls_train.make_policy_eval_step(criterion, cfg, f, a)
    # the budget-matched control: the same draws, so the same num_fixs and
    # fixation 0; only the later saccades differ
    rnd_eval = rls_train.make_policy_eval_step(criterion, cfg, f, a, greedy=False)
    gen, host = _draws(dev, seed, 0), torch.Generator().manual_seed(seed * 100_003 + 500_000)
    given = None if draws is None else iter(draws)

    def next_draws() -> rls_train.RolloutDraws:
        if given is None:
            return rls_train.draw_rollout(gen, host, b, f)
        d = next(given)
        return d._replace(random_fix=d.random_fix.to(dev))

    oracle = OracleDQN(a)
    phase_a = [step_a(state, oracle, images, labels, 1, next_draws())[0]["loss_ce"]
               for _ in range(na)]
    dqn_losses, rewards = [], []
    for i in range(nb):
        epoch = 1 + i // 10
        _, ro, reward = step_b(copy.deepcopy(state), dqn, images, labels, epoch, next_draws())
        rewards.append(reward.mean())
        nf = f - int(ro.mask[0].sum())
        memory.push(ro.glimpses[:, nf - 2], ro.saccades[:, nf - 1], ro.glimpses[:, nf - 1],
                    reward)
        if len(memory) >= 48:
            dqn_losses.append(dqn_upd(pstate, target, memory.sample(48)))
    eval_draws = [next_draws() for _ in range(evals)]
    pol = _mean(pol_eval(state, dqn, images, labels, d)["top1"] for d in eval_draws)
    rnd = _mean(rnd_eval(state, dqn, images, labels, d)["top1"] for d in eval_draws)
    return {"policy": pol, "random": rnd, "losses": _floats(phase_a),
            "phase_b_reward": _floats(rewards), "dqn_losses": _floats(dqn_losses),
            "device": _device_of(model)}


CASES = {"simclr": simclr_case, "probe": probe_case, "detr": detr_case, "dqn": dqn_case,
         "caption": caption_case, "captioner": captioner_case, "rls": rls_case}


# ---------------------------------------------------------------------------
# the SimCLR loss curve of tools/loss_curve_parity.py, on the port


def simclr_curve(model: nn.Module, views_for, steps: int, fixations: int, batch: int,
                 base_lr: float = 0.8, temperature: float = 0.05) -> np.ndarray:
    """Per-update NT-Xent losses of ``model`` trained on the glimpse stream
    ``views_for(step) -> (F+1, B, 30, 30, 12)`` (numpy, moved to the
    model's device): per step the first view forwards in train mode without
    gradient, then each fixation's loss against the previous view's
    projections (detached), backward and one Adam update under
    :func:`~schedule.simclr_learning_rate` (linear scaling, warm-up 1 epoch,
    10 train epochs of ``steps`` batches), as ``run_jax`` sets them."""
    dev = next(model.parameters()).device
    sched = schedule.simclr_learning_rate(base_lr, batch, num_examples=steps * batch,
                                          batch_size=batch, warmup_epochs=1, train_epochs=10)
    state = TrainState(model, get_optimizer("adam", model.parameters()), sched)
    model.train()
    curve = []
    for t in range(steps):
        views = torch.from_numpy(views_for(t)).to(dev)
        with torch.no_grad():
            h1 = model(views[0])
        for j in range(1, fixations + 1):
            h2 = model(views[j])
            loss, _, _ = contrastive_loss(h1, h2, temperature=temperature)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            scheduled_update(state)
            curve.append(loss.detach())
            h1 = h2.detach()
    return np.asarray(torch.stack(curve).cpu(), np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    missed = 0
    for name in args.cases.split(","):
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = CASES[name](device, seed)
            secs = time.perf_counter() - t0
            m = misses(name, r)
            missed += bool(m)
            nums = {k: round(v, 4) for k, v in r.items() if isinstance(v, float)}
            print(f"{name} seed {seed} on {where}: {nums}; "
                  f"{'met' if not m else 'MISSED ' + '; '.join(m)} ({secs:.1f} s)", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
