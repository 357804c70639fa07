"""The foveated retina's ``matmul`` mode, plain and in float32.

A frozen statement of the documented semantics (the port's
``ops/retina.py`` and the plain glimpse sampler, which follow the JAX
package's ``glimpse_sample_xla``), written again here so that the
reference shares no code with the program:

* the mip chain: the uint8 canvas rounded to bf16, each coarser level the
  float32 mean of 2×2 pixels of the previous bf16-rounded level, rounded
  to bf16 again;
* each crop level samples the mip whose spacing is about half the glimpse
  lattice's (:func:`mip_levels`), inside a 16-aligned window
  (:func:`window_size`), at coordinates composed from the fixation, the
  flip, the rotation about the canvas centre and the RandomResizedCrop
  window, with the grid-mask keep and the rotation's out-of-canvas test
  folded into one multiplier;
* bilinear ("hat") weights, the ``y`` weights rounded to bf16, window-
  relative coordinates clamped to the window;
* photometrics: ``+ N(0, 1)·std + mean`` over all ``3L`` channels, then
  each image's DALI ColorTwist (YIQ hue rotation and saturation, contrast
  about 128, brightness) within every level.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.322],
                    [0.211, -0.523, 0.312]], dtype=np.float64)
YIQ2RGB = np.linalg.inv(RGB2YIQ)


class Params(NamedTuple):
    """Per-image augmentation parameters, the fields in the port's
    ``AugParams`` order: ``(B,)`` or ``(B, 2)`` each."""

    fix_yx: torch.Tensor
    angle: torch.Tensor
    rrc_origin_yx: torch.Tensor
    rrc_size_hw: torch.Tensor
    flip: torch.Tensor
    noise_mean: torch.Tensor
    noise_std: torch.Tensor
    gm_ratio: torch.Tensor
    gm_tile: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    hue: torch.Tensor
    saturation: torch.Tensor


def labeled_params(fix_yx: torch.Tensor, canvas: int) -> Params:
    """No rotation, crop or photometrics; the fixations ``(B, 2)`` (y, x)."""
    n = fix_yx.shape[0]
    f32 = dict(dtype=torch.float32, device=fix_yx.device)
    z, o = torch.zeros(n, **f32), torch.ones(n, **f32)
    return Params(fix_yx.to(torch.float32), z, torch.zeros(n, 2, **f32),
                  torch.full((n, 2), float(canvas), **f32),
                  torch.zeros(n, dtype=torch.bool, device=fix_yx.device),
                  z, z, z, o, o, o, z, o)


def mip_levels(crop_sizes, glimpse: int) -> dict[int, int]:
    """``{crop: factor}``: the largest power of two at most 0.66 times the
    lattice spacing ``crop / glimpse``."""
    out = {}
    for crop in crop_sizes:
        factor = 1
        while factor * 2 <= crop / glimpse * 0.66:
            factor *= 2
        out[crop] = factor
    return out


def window_size(crop: int, factor: int, mip_size: int) -> int:
    """Window side in mip pixels: ``crop·√2 + 6`` over the factor, 4 px of
    margin and 16 of alignment slack, rounded up to 16, at most the mip."""
    span = int(crop * 1.4143) + 6
    return min(-(-(span // factor + 4 + 16) // 16) * 16, mip_size)


def build_pyramid(images: torch.Tensor, factors) -> dict[int, torch.Tensor]:
    """``(B, S, S, 3)`` uint8 → ``{factor: (B, M, M, 3)}`` bf16 (each level
    exact in bf16, so it is held as such)."""
    m = images.to(torch.bfloat16)
    mips = {1: m}
    f = 1
    while f < max(factors):
        b, h, w, c = m.shape
        m = m.float().reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)).to(torch.bfloat16)
        f *= 2
        mips[f] = m
    return mips


def _rotate(coords: torch.Tensor, angle: torch.Tensor, center: float) -> torch.Tensor:
    theta = (angle * (math.pi / 180.0)).reshape(-1, *([1] * (coords.dim() - 2)))
    cos, sin = torch.cos(theta), torch.sin(theta)
    y, x = coords[..., 0] - center, coords[..., 1] - center
    return torch.stack([sin * x + cos * y, cos * x - sin * y], -1) + center


def _grid_keep(coords: torch.Tensor, p: Params) -> torch.Tensor:
    lead = (-1,) + (1,) * (coords.dim() - 2)
    theta = (p.angle * (math.pi / 180.0)).reshape(lead)
    cos, sin = torch.cos(theta), torch.sin(theta)
    y = coords[..., 0] - p.fix_yx[:, 0].reshape(lead)
    x = coords[..., 1] - p.fix_yx[:, 1].reshape(lead)
    xr, yr = cos * x - sin * y, sin * x + cos * y
    tile = p.gm_tile.clamp(min=1.0).reshape(lead)
    ratio = p.gm_ratio.reshape(lead)

    def floor_mod(v):
        r = torch.fmod(v, tile)
        return torch.where((r != 0) & ((r < 0) != (tile < 0)), r + tile, r)

    cut = ratio * tile
    masked = (floor_mod(xr) < cut) & (floor_mod(yr) < cut) & (ratio > 0)
    return torch.where(masked, 0.0, 1.0)


class LevelPlan(NamedTuple):
    """One level's sampling plan: window-relative mip coordinates
    ``rel_y``/``rel_x`` ``(B, P)``, window origins ``start`` ``(B, 2)``
    int64, the per-point multiplier ``scale`` ``(B, P)``, the window side
    and the mip factor."""

    rel_y: torch.Tensor
    rel_x: torch.Tensor
    start: torch.Tensor
    scale: torch.Tensor
    win: int
    factor: int


def level_plan(p: Params, canvas: int, glimpse: int, crop: int, factor: int,
               mip_size: int) -> LevelPlan:
    c = float(canvas)
    batch = p.fix_yx.shape[0]
    dev = p.fix_yx.device
    win = window_size(crop, factor, mip_size)
    base = (torch.arange(glimpse, dtype=torch.float32, device=dev) + 0.5) * (crop / glimpse) - 0.5
    origin = p.fix_yx * (c - crop)
    yy = (base[None, :, None] + origin[:, 0, None, None]).expand(batch, glimpse, glimpse)
    xx = (base[None, None, :] + origin[:, 1, None, None]).expand(batch, glimpse, glimpse)
    xx = torch.where(p.flip[:, None, None], (c - 1.0) - xx, xx)
    coords = torch.stack([yy, xx], -1)
    keep = _grid_keep(coords, p)
    a = _rotate(coords, p.angle, (c - 1) / 2)
    oob = (a < -0.5).any(-1) | (a > c - 0.5).any(-1)
    s = p.rrc_origin_yx[:, None, None, :] + (a + 0.5) * (p.rrc_size_hw[:, None, None, :] / c) - 0.5
    if factor > 1:
        s = (s + 0.5) / factor - 0.5
    s = s.reshape(batch, -1, 2)
    if win < mip_size:
        start = (torch.floor(s.amin(dim=1)) - 1.0).clamp(0.0, mip_size - win).long()
        start = torch.div(start, 16, rounding_mode="floor") * 16
    else:
        start = torch.zeros(batch, 2, dtype=torch.long, device=dev)
    rel = s - start.to(torch.float32)[:, None, :]
    scale = (keep * (1.0 - oob.to(torch.float32))).reshape(batch, -1)
    return LevelPlan(rel[..., 0], rel[..., 1], start, scale, win, factor)


def plans(p: Params, canvas: int, glimpse: int, crop_sizes) -> list[LevelPlan]:
    """Every level's plan, mip sides from the canvas."""
    factors = mip_levels(crop_sizes, glimpse)
    return [level_plan(p, canvas, glimpse, crop, factors[crop], canvas // factors[crop])
            for crop in crop_sizes]


def hat_sample(mip: torch.Tensor, rows: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """One level: plan row ``b`` reads mip image ``rows[b]``; ``(B, P, 3)``."""
    m, win = mip.shape[1], plan.win
    b = plan.rel_y.shape[0]
    s = plan.start.clamp(0, m - win)
    ar = torch.arange(win, device=mip.device)
    patch = mip[rows[:, None, None], (s[:, 0:1] + ar)[:, :, None], (s[:, 1:2] + ar)[:, None, :]]
    idx = ar.to(torch.float32)
    ry = plan.rel_y.clamp(0.0, win - 1.0)[..., None]
    rx = plan.rel_x.clamp(0.0, win - 1.0)[..., None]
    wy = torch.clamp_min(1.0 - (ry - idx).abs(), 0.0).to(torch.bfloat16).to(torch.float32)
    wx = torch.clamp_min(1.0 - (rx - idx).abs(), 0.0)
    tmp = torch.bmm(wy, patch.float().reshape(b, win, win * 3))
    return (tmp.view(b, -1, win, 3) * wx[..., None]).sum(2) * plan.scale[..., None]


def color_twist(p: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """Each image's ``rgb → M·rgb + b``: ``M`` ``(B, 3, 3)``, ``b`` ``(B, 3)``."""
    h = p.hue * (math.pi / 180.0)
    cos, sin, s = torch.cos(h), torch.sin(h), p.saturation
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    hs = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, s * cos, -s * sin], -1),
                      torch.stack([zero, s * sin, s * cos], -1)], -2)
    dev = hs.device
    m = (torch.as_tensor(YIQ2RGB, dtype=torch.float32, device=dev) @ hs
         @ torch.as_tensor(RGB2YIQ, dtype=torch.float32, device=dev))
    m = (p.brightness * p.contrast)[:, None, None] * m
    return m, (p.brightness * 128.0 * (1.0 - p.contrast))[:, None].expand(-1, 3)


def glimpses(mips: dict, p: Params, canvas: int, glimpse: int, crop_sizes,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, g, g, 3L)`` float32 glimpse stacks of plan rows ``p`` (row
    ``b`` samples source image ``b % B_src``); with ``noise`` ``(B, g, g,
    3L)`` the photometric view, else the labeled one."""
    batch = p.fix_yx.shape[0]
    rows = torch.arange(batch, device=p.fix_yx.device) % mips[1].shape[0]
    out = torch.cat([hat_sample(mips[pl.factor], rows, pl)
                     for pl in plans(p, canvas, glimpse, crop_sizes)], -1)
    out = out.reshape(batch, glimpse, glimpse, 3 * len(crop_sizes))
    if noise is None:
        return out
    out = out + noise * p.noise_std[:, None, None, None] + p.noise_mean[:, None, None, None]
    m, b = color_twist(p)
    levels = len(crop_sizes)
    out = out.reshape(batch, glimpse, glimpse, levels, 3)
    out = torch.einsum("bhwlc,bdc->bhwld", out, m) + b[:, None, None, None, :]
    return out.reshape(batch, glimpse, glimpse, 3 * levels)
