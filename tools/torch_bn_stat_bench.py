#!/usr/bin/env python3
"""BatchNorm statistics at the ResNet-50 b=128 shapes: the port's ``bn``
form against the ``stat_sums`` kernel (B2) (port of ``tools/bn_stat_bench.py``).

For each ``(N, C)`` of :data:`SHAPES` (the JAX tool's: ResNet-50's
BatchNorm inputs at batch 128 on 30x30 glimpses), in bf16 by default:

* ``bn``: ``models/norm.BatchNorm._batch_stats``, float32 ``mean`` and the
  one-pass biased ``var`` as PyTorch reductions;
* ``B2``: ``ops/stat_sums.batch_mean_var``, one ``stat_sums`` launch;

each held against float64 (the same fast form, ``E[x²] − E[x]²``), and B2's
``(Σx, Σx²)`` against its plain version ``stat_sums_plain`` with phase 2's
tolerance (normwise 1e-5). On the card it then times both forms as
``chip_smoke.py`` times kernels (CUDA events, the L2 flushed before each
call) and prints per shape the ms, GB/s and share of the H100's 3.35 TB/s
for the bytes the function must move (the input read once, the statistics
written once), then the totals for one pass over the eight shapes, with
the card's name and power limit::

    python3 tools/torch_bn_stat_bench.py [--iters 20] [--dtype bfloat16]

``--device cpu`` checks the agreement on the CPU (B2's wrapper runs its
plain version there) and times nothing. It imports torch and the port,
never JAX or the JAX package; without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke
from multimodal_active_ai_tpu_torch.device import resolve_device
from multimodal_active_ai_tpu_torch.models.norm import BatchNorm
from multimodal_active_ai_tpu_torch.ops import stat_sums as ss

# ResNet-50's BatchNorm shapes at batch 128 (N = B*H*W, C), as in the JAX tool
SHAPES = [
    (128 * 30 * 30, 64),     # stem + layer1 1x1/3x3 outputs
    (128 * 30 * 30, 256),    # layer1 expansions
    (128 * 15 * 15, 128),    # layer2 narrow
    (128 * 15 * 15, 512),    # layer2 expansions
    (128 * 8 * 8, 256),      # layer3 narrow
    (128 * 8 * 8, 1024),     # layer3 expansions
    (128 * 4 * 4, 512),      # layer4 narrow
    (128 * 4 * 4, 2048),     # layer4 expansions
]
SUMS_TOL = 1e-5       # chip_smoke.py phase 2's normwise bound on B2's sums


def normwise(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |got − ref| / max |ref|`` in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def float64_stats(x: torch.Tensor):
    """``(mean, var)`` over axis 0 in float64, the fast biased form."""
    xd = x.double()
    mean = xd.mean(0)
    return mean, (xd * xd).mean(0) - mean * mean


def check_shape(x: torch.Tensor) -> dict:
    """Both forms against float64 and B2's sums against ``stat_sums_plain``
    for one ``(N, C)`` input: the normwise errors and whether B2's sums
    are within :data:`SUMS_TOL`."""
    bn = BatchNorm(x.shape[1]).to(x.device)
    ref_mean, ref_var = float64_stats(x)
    out = {}
    for form, (mean, var) in (("bn", bn._batch_stats(x)), ("b2", ss.batch_mean_var(x))):
        out[form] = (normwise(mean, ref_mean), normwise(var, ref_var))
    got, plain = ss.stat_sums(x), ss.stat_sums_plain(x)
    out["b2_sums"] = max(normwise(g, p) for g, p in zip(got, plain))
    out["ok"] = out["b2_sums"] <= SUMS_TOL
    return out


def run(device: torch.device, dtype: torch.dtype = torch.bfloat16, iters: int = 20,
        seed: int = 0) -> list[dict]:
    """Every shape of :data:`SHAPES` checked (:func:`check_shape`) and, on the
    card, timed: one row a shape with the errors, the bytes the function
    must move, their time at 3.35 TB/s (``bound_ms``) and, on CUDA, ``bn_ms``
    and ``b2_ms``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    timed = device.type == "cuda"
    if timed:
        flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=device).zero_
    rows = []
    for n, c in SHAPES:
        x = torch.randn(n, c, device=device, generator=gen).to(dtype)
        nbytes = x.numel() * x.element_size() + 2 * c * 4
        row = {"shape": (n, c), "bytes": nbytes,
               "bound_ms": 1e3 * nbytes / chip_smoke.PEAK_BYTES_PER_S, **check_shape(x)}
        if timed:
            bn = BatchNorm(c).to(device)
            row.update(bn_ms=chip_smoke.time_ms(lambda: bn._batch_stats(x), torch, iters, flush),
                       b2_ms=chip_smoke.time_ms(lambda: ss.batch_mean_var(x), torch, iters,
                                                flush))
        rows.append(row)
    return rows


def print_rows(rows: list[dict], card: str) -> None:
    """The per-shape table and the totals for one pass."""
    print(f"{'shape':>18} {'MB':>6} | bn err mean/var | B2 err mean/var | B2 sums vs plain"
          + (" | bn ms  GB/s  %peak | B2 ms  GB/s  %peak" if "bn_ms" in rows[0] else ""))
    for r in rows:
        n, c = r["shape"]
        line = (f"{n:>10}x{c:<7} {r['bytes'] / 1e6:6.1f} | {r['bn'][0]:.1e}/{r['bn'][1]:.1e} | "
                f"{r['b2'][0]:.1e}/{r['b2'][1]:.1e} | {r['b2_sums']:.1e} "
                f"{'ok' if r['ok'] else 'MISMATCH'}")
        if "bn_ms" in r:
            for form in ("bn", "b2"):
                t = r[f"{form}_ms"]
                line += (f" | {t:.4f} {r['bytes'] / t / 1e6:5.0f} "
                         f"{100 * r['bound_ms'] / t:5.1f}%")
        print(line)
    if "bn_ms" in rows[0]:
        tot = {k: sum(r[k] for r in rows) for k in ("bn_ms", "b2_ms", "bound_ms", "bytes")}
        share = {k: 100 * tot["bound_ms"] / tot[f"{k}_ms"] for k in ("bn", "b2")}
        print(f"total per pass: bn {tot['bn_ms']:.4f} ms, B2 {tot['b2_ms']:.4f} ms "
              f"({tot['bn_ms'] / tot['b2_ms']:.2f}x), bound {tot['bound_ms']:.4f} ms "
              f"({tot['bytes'] / 1e6:.1f} MB at 3.35 TB/s: bn {share['bn']:.1f}%, "
              f"B2 {share['b2']:.1f}% of it) [{card}]")
    else:
        print(f"times: not measured (the CPU) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = chip_smoke.gpu_name_and_power() if device.type == "cuda" else "cpu"
    rows = run(device, getattr(torch, args.dtype), args.iters)
    print_rows(rows, card)
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        print(f"bn_stat_bench: B2 disagrees with its plain version at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
