#!/usr/bin/env python
"""Model-zoo shape smoke tests on the PyTorch port (notebook parity).

The port's twin of ``examples/resnet_tests.py`` (the reference's ``ResNet
Tests.ipynb``): the legacy 15-channel ResNet on a ``(1, 20, 30, 15)`` input
and the 1-D ResNet-101 on a ``(1, 5008, 1)`` signal, both in eval mode.
Runs on ``--device cuda`` (default) or ``--device cpu``::

    python examples/torch_resnet_tests.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.models.resnet1d import resnet1d_101  # noqa: E402
from multimodal_active_ai_tpu_torch.models.resnet_legacy import legacy_resnet18  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    device = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator().manual_seed(0)

    legacy = legacy_resnet18(norm_kind="bn", generator=gen).to(device).eval()
    x = torch.randn((1, 20, 30, 15), generator=gen).to(device)
    r1d = resnet1d_101(length=5008, generator=gen).to(device).eval()
    sig = torch.randn((1, 5008, 1), generator=gen).to(device)   # a multiple of the final pool
    with torch.no_grad():
        out = legacy(x)
        print("LegacyResNet18 (1, 20, 30, 15) ->", tuple(out.shape))
        logits = r1d(sig)
        print("ResNet1d-101 (1, 5008, 1) ->", tuple(logits.shape))
    return {"legacy": out, "resnet1d": logits}


if __name__ == "__main__":
    main()
