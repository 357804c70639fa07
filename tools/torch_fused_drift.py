#!/usr/bin/env python3
"""How far two float32 trainings of one model drift apart on the card when
only their rounding differs.

Case 1 of ``tools/torch_convergence.py`` (SimCLR on 32 fixed images, F=1,
Adam 1e-3, T=0.5) at ResNet50 for ``--steps`` steps from one init and one
generator seed, trained once per variant:

* ``bn`` twice (cuDNN's default algorithms, which may differ per run),
  and twice with ``cudnn.deterministic``;
* ``bn_fused`` (the B2 kernel in every BatchNorm), ``bn_fused`` +
  ``stat_fusion='pallas'`` twice (B2 and the B3 kernel), and
  ``bn_fused`` + ``stat_fusion='gram'``;
* ``bn`` with the network in float64 (the retina's glimpses and the loss
  stay float32): the reference the others drift from.

Prints each run's per-step losses and their relative difference from the
``bn`` run and from the float64 run. It tells a kernel fault (one variant
far from the float64 run, the others near) from the growth of rounding
through Adam (every float32 variant, ``bn`` against itself included, as
far from the others). Run on a CUDA machine from the repository root:

    python3 tools/torch_fused_drift.py [--steps 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from chip_smoke import gpu_name_and_power  # noqa: E402
from tools import torch_convergence as tc  # noqa: E402

FUSED = dict(norm_kind="bn_fused", stat_fusion="pallas")


class Float64(nn.Module):
    """A model whose weights and activations are float64; its input is
    cast on the way in."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.double()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.double())


def run(steps: int, float64: bool = False, **kinds) -> torch.Tensor:
    kept = tc._place
    if float64:
        tc._place = lambda model, device: Float64(model.to(device))
    try:
        r = tc.simclr_case("cuda", 0, steps=steps, evals=1, arch="ResNet50", **kinds)
    finally:
        tc._place = kept
    return torch.tensor(r["losses"], dtype=torch.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = [("bn", {}), ("bn again", {}), ("bn_fused", dict(norm_kind="bn_fused")),
                ("bn_fused + pallas", FUSED), ("bn_fused + pallas again", FUSED),
                ("bn_fused + gram", dict(norm_kind="bn_fused", stat_fusion="gram")),
                ("bn deterministic", dict(deterministic=True)),
                ("bn deterministic again", dict(deterministic=True)),
                ("bn float64", dict(float64=True))]
    runs = {}
    for label, kw in variants:
        kw = dict(kw)
        deterministic = kw.pop("deterministic", False)
        torch.backends.cudnn.deterministic = deterministic
        t0 = time.perf_counter()
        runs[label] = run(args.steps, **kw)
        torch.backends.cudnn.deterministic = False
        print(f"{label}: {[round(x, 5) for x in runs[label].tolist()]} "
              f"({time.perf_counter() - t0:.1f} s)")
    name = gpu_name_and_power()
    for ref in ("bn", "bn float64"):
        print(f"largest relative difference from {ref} over {args.steps} steps [{name}]:")
        for label, losses in runs.items():
            if label != ref:
                rel = (losses - runs[ref]).abs() / runs[ref].abs()
                print(f"  {label:24s} {rel.max().item():.3e} (step {int(rel.argmax())}; first "
                      f"above 1e-3 at step {next((i for i, r in enumerate(rel) if r > 1e-3), '-')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
