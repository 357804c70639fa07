"""The comparison that decides ``correct`` for a training cell.

The program and the reference each give, over the run's first steps (the
same object that then goes into the window, fed the window's own call):

* ``out``: the model's first output of the run (SimCLR: view 0's
  projections; DETR: the first step's class logits), which the retina's
  glimpses and the whole forward pass make;
* ``losses``: every loss the steps returned;
* ``grads``: each parameter's gradient norm at the first update, as the
  optimizer got it, and ``grad_vecs`` that gradient itself;
* ``change``: each parameter's distance from the seed's weights after the
  checked steps.

:func:`numbers` turns the two into gaps: ``out`` (relative L2), ``loss``
(the largest relative gap of a loss), and for ``grad`` (the worst leaf),
``grad_med`` (the median leaf) and ``change`` (the worst leaf) the gap
between the program's norm and the reference's over the reference's norm
of that leaf or of the median leaf, whichever is larger; ``grad_dir`` is
the median leaf's ``1 - cos`` of the angle between the two first
gradients, which sees a gradient of the right size that points elsewhere
(a loss over the wrong rows, whose scale the clip and Adam take out of
every other number). Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of those three: their gradient is nought to rounding (such a leaf moves
under Adam by round-off alone). A leaf that the program leaves without a
gradient or unmoved reads its norm as 0. A cell's limits file names the
numbers it holds; the others are read and printed, not held.
"""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import torch


class Readings(NamedTuple):
    out: torch.Tensor             # the model's first output, float32 on the CPU
    losses: torch.Tensor          # (steps, k) float64 on the CPU
    grads: dict[str, float]
    change: dict[str, float]
    grad_vecs: dict[str, torch.Tensor]   # flattened, float32 on the CPU


def _gaps(prog: dict, ref: dict, keep: list[str]) -> list[float]:
    floor = statistics.median(ref[n] for n in keep)
    return [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor) for n in keep]


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """The gaps: ``out`` (the first output, relative L2), ``loss`` (the
    largest of the losses'), ``grad`` (the worst leaf's), ``grad_med`` (the
    median leaf's), ``grad_dir`` (the median leaf's angle) and ``change``
    (the worst leaf's)."""
    out = loss = math.inf
    if prog.out.shape == ref.out.shape:
        out = float((prog.out.double() - ref.out.double()).norm() / ref.out.double().norm())
    if prog.losses.shape == ref.losses.shape:
        loss = float(((prog.losses - ref.losses).abs() / ref.losses.abs().clamp_min(1e-12)).max())
    med = statistics.median(ref.grads.values())
    keep = [n for n, g in ref.grads.items() if g >= 1e-3 * med]
    grad = _gaps(prog.grads, ref.grads, keep)
    return {"out": out, "loss": loss, "grad": max(grad), "grad_med": statistics.median(grad),
            "grad_dir": statistics.median(_angle_gap(prog.grad_vecs.get(n), ref.grad_vecs[n])
                                          for n in keep),
            "change": max(_gaps(prog.change, ref.change, keep))}


def _angle_gap(a: torch.Tensor | None, b: torch.Tensor) -> float:
    """``1 - cos`` of the angle between two gradients (1 for a missing or
    zero one)."""
    if a is None or a.shape != b.shape:
        return 1.0
    a, b = a.double(), b.double()
    den = float(a.norm() * b.norm())
    return 1.0 - float(a @ b) / den if den > 0 else 1.0


def judge(nums: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number the cell's limits hold, beside its
    limit; the other numbers are read but not held."""
    checks = {n: {"value": nums[n], "limit": lim} for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
