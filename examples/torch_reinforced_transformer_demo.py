#!/usr/bin/env python
"""Glimpse-captioner demo on the PyTorch port (Reinforced Transformer
notebook parity).

The port's twin of ``examples/reinforced_transformer_demo.py``: the retina
collects a glimpse sequence at saccades the DQN policy proposes (the
framework's motor generator; untrained here, the RLS driver trains it),
one glimpse sampler launch per fixation; a frozen encoder gives per-glimpse
features; the ``GlimpseCaptioner`` takes five teacher-forcing Adam steps on
toy captions (eval mode, no dropout, as the JAX demo); greedy decoding
generates token ids from the glimpse memory. Runs on ``--device cuda``
(default) or ``--device cpu``::

    python examples/torch_reinforced_transformer_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn  # noqa: E402
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule  # noqa: E402
from multimodal_active_ai_tpu_torch.models.text import (  # noqa: E402
    BOS_ID, PAD_ID, GlimpseCaptioner, tokenize)
from multimodal_active_ai_tpu_torch.ops import retina  # noqa: E402
from multimodal_active_ai_tpu_torch.train.rls_train import draw_rollout, make_rollout  # noqa: E402

VOCAB = 512
MAX_LEN = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    device = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=device).manual_seed(15)
    init = torch.Generator().manual_seed(15)
    cfg = retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30), glimpse_size=30,
                              supersample=1)
    batch, fixations = 4, 3
    images = torch.randint(0, 256, (batch, 64, 64, 3), generator=gen, dtype=torch.uint8,
                           device=device)

    # motor generator: the DQN policy proposes where to look next from the
    # previous glimpse (epoch 1, ε coins from the host generator)
    dqn = build_dqn("ResNet18", num_of_actions=100, norm_kind="bn", generator=init).to(device)
    rollout = make_rollout(cfg, fixations, num_of_actions=100, eps_start=0.9, eps_end=0.05,
                           eps_decay=30.0)
    draws = draw_rollout(gen, torch.Generator().manual_seed(15), batch, fixations)
    ro = rollout(dqn, images, draws, 1)
    print("glimpse sequence:", tuple(ro.glimpses.shape), "saccades:", tuple(ro.saccades.shape))

    # frozen encoder features per glimpse
    enc = SimCLRModule(arch="ResNet18", norm_kind="bn", generator=init).to(device).eval()
    with torch.no_grad():
        feats = torch.stack([enc.features(ro.glimpses[:, j]).reshape(batch, -1)
                             for j in range(fixations)], dim=1)
    print("glimpse features:", tuple(feats.shape))

    # caption decoder: a few teacher-forcing steps on toy captions
    captions = ["a red square", "a blue circle", "a green dot", "a cat"]
    toks = torch.tensor([tokenize(c, VOCAB, MAX_LEN)[0] for c in captions], device=device)
    model = GlimpseCaptioner(feats.shape[-1], vocab_size=VOCAB, d_model=64, nhead=4,
                             num_layers=2, dim_feedforward=128, generator=init).to(device).eval()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    targets = toks[:, 1:]
    ces = []
    for i in range(5):
        logits = model(feats, toks[:, :-1])
        ce = F.cross_entropy(logits.reshape(-1, VOCAB), targets.reshape(-1), reduction="none")
        loss = torch.where(targets.reshape(-1) != PAD_ID, ce, 0.0).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        ces.append(float(loss.detach()))
        print(f"caption CE step {i}: {ces[-1]:.4f}")

    # greedy decoding from the glimpse memory
    ids = torch.full((batch, 1), BOS_ID, dtype=torch.int64, device=device)
    with torch.no_grad():
        for _ in range(MAX_LEN - 1):
            nxt = model(feats, ids)[:, -1].argmax(dim=-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    print("greedy-decoded token ids:\n", ids.cpu().numpy())
    return {"glimpses": ro.glimpses, "losses": ces, "ids": ids}


if __name__ == "__main__":
    main()
