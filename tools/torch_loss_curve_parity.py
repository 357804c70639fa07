#!/usr/bin/env python
"""SimCLR loss-curve parity: the PyTorch port against the JAX package.

BASELINE.md target 2 ("NT-Xent loss curves within 1% of a PyTorch re-run")
with the port as the re-run. The configuration is
``tools/loss_curve_parity.py``'s: ResNet-18, F=2, b=64, base lr 0.8
(linear scaling, warm-up 1 epoch, 10 train epochs), T=0.05, seed 15, on its
seeded numpy glimpse stream. The JAX side is that tool's ``run_jax``; the
port's side is ``SimCLRModule(arch="ResNet18")`` built from the same
initial variables through ``utils.checkpoint.from_jax_variables`` and
trained by ``tools/torch_convergence.simclr_curve`` (the port's NT-Xent,
Adam and schedule, train-mode BatchNorm, the earlier view detached) on the
same stream. Both run on the CPU: the JAX package is the reference here.

Run:  MAAI_PLATFORM=cpu python tools/torch_loss_curve_parity.py [--steps 50]
Prints both curves and the largest relative difference; exits non-zero if
any update differs by more than 1%.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def port_from_jax_init(init):
    """The port's SimCLR ResNet-18 with the JAX ``(params, batch_stats)``."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.utils.checkpoint import from_jax_variables

    model = SimCLRModule(arch="ResNet18")
    model.load_state_dict(from_jax_variables(*init))
    return model


def compare(steps=50, fixations=2, batch=64, base_lr=0.8, temperature=0.05, seed=15,
            tol=0.01, verbose=True):
    """``(jax_curve, port_curve, max relative difference)`` over
    ``steps·fixations`` updates."""
    from tools.loss_curve_parity import run_jax, view_stream
    from tools.torch_convergence import simclr_curve

    jax_curve, init = run_jax(steps, fixations, batch, base_lr, temperature, seed)
    port_curve = simclr_curve(port_from_jax_init(init), view_stream(seed, steps, fixations, batch),
                              steps, fixations, batch, base_lr, temperature)
    rel = np.abs(port_curve - jax_curve) / np.abs(jax_curve)
    if verbose:
        print(f"{'update':>6} {'jax':>12} {'port':>12} {'rel':>10}")
        for i, (a, b, r) in enumerate(zip(jax_curve, port_curve, rel)):
            print(f"{i:6d} {a:12.6f} {b:12.6f} {r:10.2e}")
        print(f"max rel diff over {len(rel)} updates: {rel.max():.3e} (tolerance {tol})")
    return jax_curve, port_curve, float(rel.max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--fixations", type=int, default=2)
    ap.add_argument("-b", "--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.8)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--tol", type=float, default=0.01)
    args = ap.parse_args(argv)
    _, _, worst = compare(args.steps, args.fixations, args.batch_size, args.lr,
                          args.temperature, args.seed, args.tol)
    if worst > args.tol:
        print(f"FAIL: max relative loss difference {worst:.4f} > {args.tol}")
        return 1
    print(f"PASS: the port's loss curve within {args.tol:.1%} of the JAX package's over "
          f"{args.steps * args.fixations} updates")
    return 0


if __name__ == "__main__":
    sys.exit(main())
