#!/usr/bin/env python
"""End-to-end SimCLR chain demo on the PyTorch port (notebook parity).

The port's twin of ``examples/contrastive_learning_demo.py`` (the
reference's ``Contrastive Learning.ipynb``): synthetic canvases → two
augmented retina views (the glimpse sampler kernel on the card) → SimCLR
forward on both → the naive O(N²) NT-Xent oracle and the production
cross-batch loss → one optimizer construction and one train step, each
stage printing its shapes. Runs on ``--device cuda`` (default) or
``--device cpu``::

    python examples/torch_contrastive_learning_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule  # noqa: E402
from multimodal_active_ai_tpu_torch.objectives.ntxent import (  # noqa: E402
    contrastive_loss, naive_ntxent_loss)
from multimodal_active_ai_tpu_torch.ops import retina  # noqa: E402
from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    device = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=device).manual_seed(15)
    cfg = retina.RetinaConfig(canvas_size=256, crop_sizes=(160, 96, 40, 30), supersample=2)
    batch = 8

    # "reader": synthetic uint8 canvases (the notebook reads MSCOCO)
    images = torch.randint(0, 256, (batch, 256, 256, 3), generator=gen, dtype=torch.uint8,
                           device=device)
    print("reader batch:", tuple(images.shape), images.dtype)

    # retina: two augmented views of the same batch
    p1 = retina.sample_unlabeled_params(gen, batch, 256, cfg)
    p2 = retina.sample_unlabeled_params(gen, batch, 256, cfg)
    v1 = retina.unlabeled_glimpses(images, p1, cfg, generator=gen)
    v2 = retina.unlabeled_glimpses(images, p2, cfg, generator=gen)
    print("glimpse stacks:", tuple(v1.shape), "(B, 30, 30, 12)")

    # SimCLR module: encoder f (ResNet-18 with the foveated surgery) + projector g
    model = SimCLRModule(arch="ResNet18", norm_kind="bn",
                         generator=torch.Generator().manual_seed(15)).to(device).eval()
    with torch.no_grad():
        h1, h2 = model(v1), model(v2)
    print("projections:", tuple(h1.shape), "(B, 128)")

    # losses: the naive O(N²) oracle (the notebook's compute_loss) and production
    naive = naive_ntxent_loss(h1, h2, temperature=0.5)
    loss, _, _ = contrastive_loss(h1, h2, temperature=0.5)
    print(f"naive NT-Xent: {float(naive):.4f}   cross-batch NT-Xent: {float(loss):.4f}")

    # one optimizer construction and train step (the notebook stops here too)
    model.train()
    sched = schedule.simclr_learning_rate(0.01, batch, 64, batch, 1, 5)
    state = simclr_train.TrainState(model, optimizers.get_optimizer("lars", model.parameters()),
                                    sched)
    step = simclr_train.make_train_step(cfg, num_fixations=2, temperature=0.5)
    losses = step(state, images, gen)
    print("one train step, per-fixation losses:", [round(float(x), 4) for x in losses])
    return {"glimpses": v1, "naive": naive, "loss": loss, "losses": losses}


if __name__ == "__main__":
    main()
