"""The one generator of every traffic mix: inputs made from ``--seed``.

A traffic file (``benchmark/traffic/<name>.json``) holds numbers only:
``batch`` (images a rank), ``fixations``, ``canvas`` (source side),
``pool`` (distinct batches the run cycles through), ``checked_steps`` (the
first steps, which the comparison follows), ``trace_steps`` (the steps a
traced run profiles) and a ``rehearsal`` block of the same keys for the
CPU tests. Everything a run feeds comes from :func:`stream` seeds, so the
same ``--seed`` gives the same inputs:

* the image pool: ``pool`` batches of uint8 canvases, each rank's rows from
  a generator of its own (``images``), labels beside them (``labels``);
* per step, the draws of the retina (a frozen copy of the documented
  SimCLR augmentation sampler, :func:`simclr_views`), the saccades and the
  number of real fixations (:func:`saccades`), and a seed for dropout.
"""

from __future__ import annotations

import hashlib
import math

import torch

from benchmark.reference.retina import Params


def stream(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of ``--seed``'s draws."""
    h = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device).manual_seed(stream(seed, *keys))


def images(seed: int, k: int, rank: int, batch: int, canvas: int, device) -> torch.Tensor:
    """Rank ``rank``'s ``batch`` rows of pool batch ``k``: uint8 ``(B, S, S, 3)``."""
    return torch.randint(0, 256, (batch, canvas, canvas, 3), dtype=torch.uint8, device=device,
                         generator=generator(device, seed, "images", k, rank))


def labels(seed: int, k: int, rank: int, batch: int, classes: int, device) -> torch.Tensor:
    return torch.randint(0, classes, (batch,), device=device,
                         generator=generator(device, seed, "labels", k, rank))


def _u(gen, shape, low=0.0, high=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (high - low) + low


def simclr_params(gen: torch.Generator, n: int, src: int, r: dict) -> Params:
    """One SimCLR view's parameters for ``n`` images: fixation ~ U[0,1)²,
    angle ~ (U − ½)·range, RandomResizedCrop area ~ U(area) and log-uniform
    aspect (window clamped to the source), flip ~ ½; grid mask, noise and
    colour each gated by one Bernoulli draw a batch (ratio ~ U[.2,.5], tile
    ~ ⌊U[100,500]⌋; mean ~ U − ½, std ~ 100·U; brightness and contrast ~
    1 − v/2 + v·U, hue ~ hue·U, saturation ~ 1 − s + s·U)."""
    b = (n,)
    fix = _u(gen, (n, 2))
    angle = (_u(gen, b) - 0.5) * r["fixation_angle_range"]
    area = _u(gen, b, *r["rrc_area"]) * src * src
    ratio = torch.exp(_u(gen, b, math.log(r["rrc_ratio"][0]), math.log(r["rrc_ratio"][1])))
    w = torch.sqrt(area * ratio).clamp(1.0, src)
    h = torch.sqrt(area / ratio).clamp(1.0, src)
    oy, ox = _u(gen, b) * (src - h), _u(gen, b) * (src - w)
    flip = _u(gen, b) < 0.5
    gm = _u(gen, ()) < r["grid_mask_prob"]
    gm_ratio = torch.where(gm, _u(gen, b, 0.2, 0.5), 0.0)
    gm_tile = torch.where(gm, torch.floor(_u(gen, b, 100.0, 500.0)), 1.0)
    nz = _u(gen, ()) < r["gaussian_noise_prob"]
    mean = torch.where(nz, _u(gen, b) - 0.5, 0.0)
    std = torch.where(nz, _u(gen, b) * 100.0, 0.0)
    col = _u(gen, ()) < r["color_aug_prob"]
    bri, con, sat = r["brightness"], r["contrast"], r["saturation"]
    return Params(fix, angle, torch.stack([oy, ox], -1), torch.stack([h, w], -1), flip,
                  mean, std, gm_ratio, gm_tile,
                  torch.where(col, (1 - bri / 2) + bri * _u(gen, b), 1.0),
                  torch.where(col, (1 - con / 2) + con * _u(gen, b), 1.0),
                  torch.where(col, _u(gen, b) * r["hue"], 0.0),
                  torch.where(col, (1 - sat) + sat * _u(gen, b), 1.0))


def simclr_views(seed: int, step: int, views: int, n: int, src: int, r: dict, device):
    """Step ``step``'s ``views`` views of the global batch of ``n`` images:
    ``[(Params, noise (n, g, g, 3L))]``."""
    gen = generator(device, seed, "views", step)
    g, ch = r["glimpse_size"], 3 * len(r["crop_sizes"])
    out = []
    for _ in range(views):
        p = simclr_params(gen, n, src, r)
        out.append((p, torch.randn((n, g, g, ch), generator=gen, device=device)))
    return out


def saccades(seed: int, step: int, fixations: int, n: int, device):
    """Step ``step``'s real fixation count ∈ [1, F] (drawn on the host)
    and saccades ``(n, F, 2)`` (x, y) ~ U[0,1)² of the global batch."""
    num = int(torch.randint(1, fixations + 1, (), generator=torch.Generator().manual_seed(
        stream(seed, "num_fixs", step))))
    sacc = torch.rand((n, fixations, 2), device=device,
                      generator=generator(device, seed, "saccades", step))
    return num, sacc


def rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s block of a global-batch tensor (dim 0)."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def local_params(p: Params, rank: int, world: int) -> Params:
    return Params(*(rows(t, rank, world) for t in p))
