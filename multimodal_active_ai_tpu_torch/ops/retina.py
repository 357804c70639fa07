"""The foveated retina: augmentation plan + glimpse pyramid.

Port of ``multimodal_active_ai_tpu/ops/retina.py``, its three modes. A
SimCLR view of a source batch is random-resized-crop → rotate → grid-mask
→ flip → 4-level foveal crop pyramid (each level 30×30) → Gaussian noise
→ colour twist, the graph of the reference's DALI
``UnlabeledFoveatedRetinalProcessor``. In the default ``matmul`` mode the
geometric stages compose into sampling coordinates; a mip pyramid built
once per batch
(:func:`build_pyramid`) is the antialiasing prefilter, and every level
samples a static-size window of its mip with
:func:`~multimodal_active_ai_tpu_torch.ops.glimpse_sample.glimpse_sample`
(the CUDA kernel on the card). Noise is added after sampling, over all
``3L`` channels (the JAX package's documented divergence from the
reference's noise-then-downscale).

The other two modes take the source images instead of a pyramid and
sample by gather, as the JAX package does (no CUDA kernel):

* ``fused``: the same composed coordinates, each glimpse pixel the mean of
  an ``ss × ss`` box of bilinear samples (``ss = min(supersample,
  round(crop/g))``) in place of the mip prefilter; noise ``(B, g, g, 3L)``
  is added per level before the colour twist;
* ``canvas``: DALI's graph stage by stage on the whole ``c × c`` canvas
  (rotate + RandomResizedCrop warp by one bilinear gather, grid mask, noise
  ``(B, c, c, 3)``, flip, colour twist), then each level's crop resized
  with the antialiased triangle filter
  (``image_ops.crop_resize_with_filter``). It is the slow, exact mode held
  against ``tests/data/dali_golden.npz``.

:func:`foveated_pyramid` is the visualisation pipeline: every crop of one
image and its resize.

Randomness comes from an explicit ``torch.Generator``; tests may instead
hand in the augmentation parameters and the noise tensor
(:func:`noise_shape`) themselves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from multimodal_active_ai_tpu_torch.ops import image_ops
from multimodal_active_ai_tpu_torch.ops.glimpse_sample import glimpse_sample
from multimodal_active_ai_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class RetinaConfig:
    """Static retina geometry + augmentation ranges (the JAX defaults:
    640 canvas, crop pyramid 400/240/100/30, 30×30 glimpses,
    RandomResizedCrop area [0.1, 1] and aspect [3/4, 4/3])."""

    canvas_size: int = 640
    glimpse_size: int = 30
    crop_sizes: tuple[int, ...] = (400, 240, 100, 30)
    rrc_area: tuple[float, float] = (0.1, 1.0)
    rrc_ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    color_aug_prob: float = 0.5
    grid_mask_prob: float = 0.0
    gaussian_noise_prob: float = 0.5
    brightness: float = 1.0
    contrast: float = 1.0
    hue: float = 90.0
    saturation: float = 0.5
    fixation_angle_range: float = 160.0
    supersample: int = 4   # fused mode: the supersample box side, at most
    mode: str = "matmul"   # 'matmul' (the default) | 'fused' | 'canvas'

    @property
    def num_channels(self) -> int:
        return 3 * len(self.crop_sizes)


class AugParams(NamedTuple):
    """Per-image augmentation parameters, each ``(B,)`` or ``(B, 2)``
    (the fields of the JAX ``AugParams``)."""

    fix_yx: torch.Tensor        # fixation position in [0,1)², (y, x)
    angle: torch.Tensor         # rotation angle, degrees
    rrc_origin_yx: torch.Tensor  # random-resized-crop window origin, pixels
    rrc_size_hw: torch.Tensor   # window size, pixels
    flip: torch.Tensor          # bool, horizontal flip
    noise_mean: torch.Tensor
    noise_std: torch.Tensor
    gm_ratio: torch.Tensor      # grid-mask covered ratio (0 = off)
    gm_tile: torch.Tensor       # grid-mask period, pixels
    brightness: torch.Tensor
    contrast: torch.Tensor
    hue: torch.Tensor           # degrees
    saturation: torch.Tensor


def neutral_params(batch_size: int, canvas_size: int,
                   device: torch.device | str = "cpu") -> AugParams:
    """Identity-augmentation params (labeled pipelines start from these)."""
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch_size,), **f32)
    o = torch.ones((batch_size,), **f32)
    return AugParams(
        fix_yx=torch.full((batch_size, 2), 0.5, **f32),
        angle=z,
        rrc_origin_yx=torch.zeros((batch_size, 2), **f32),
        rrc_size_hw=torch.full((batch_size, 2), float(canvas_size), **f32),
        flip=torch.zeros((batch_size,), dtype=torch.bool, device=device),
        noise_mean=z, noise_std=z,
        gm_ratio=z, gm_tile=o,
        brightness=o, contrast=o, hue=z, saturation=o,
    )


def _uniform(gen: torch.Generator, shape, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (high - low) + low


def _sample_rrc_window(gen: torch.Generator, batch_size: int, src_size: int,
                       cfg: RetinaConfig):
    """RandomResizedCrop windows: area ~ U(rrc_area), log-uniform aspect,
    window dims clamped to the source (no rejection loop)."""
    area = _uniform(gen, (batch_size,), *cfg.rrc_area)
    ratio = torch.exp(_uniform(gen, (batch_size,), math.log(cfg.rrc_ratio[0]),
                               math.log(cfg.rrc_ratio[1])))
    target_area = area * src_size * src_size
    w = torch.sqrt(target_area * ratio).clamp(1.0, src_size)
    h = torch.sqrt(target_area / ratio).clamp(1.0, src_size)
    oy = _uniform(gen, (batch_size,)) * (src_size - h)
    ox = _uniform(gen, (batch_size,)) * (src_size - w)
    return torch.stack([oy, ox], -1), torch.stack([h, w], -1)


def sample_unlabeled_params(gen: torch.Generator, batch_size: int,
                            src_size: int, cfg: RetinaConfig) -> AugParams:
    """SimCLR-view augmentation parameters on ``gen``'s device.

    Fixation ~ U[0,1)², angle ~ (U-0.5)·160; grid-mask, noise and colour are
    each gated by ONE Bernoulli draw per batch (the reference draws
    ``random.uniform`` once per batch), with ratio~U[0.2,0.5],
    tile~⌊U[100,500]⌋, mean~U-0.5, std~U·100, brightness/contrast ~
    (1-v/2)+v·U, hue ~ U·hue, saturation ~ (1-s)+s·U. The gates stay on the
    device: no host synchronisation.
    """
    with span("retina.draw"):
        n = (batch_size,)
        fix = _uniform(gen, (batch_size, 2))
        angle = (_uniform(gen, n) - 0.5) * cfg.fixation_angle_range
        rrc_origin, rrc_size = _sample_rrc_window(gen, batch_size, src_size, cfg)
        flip = _uniform(gen, n) < 0.5

        gm_on = _uniform(gen, ()) < cfg.grid_mask_prob
        gm_ratio = torch.where(gm_on, _uniform(gen, n, 0.2, 0.5), 0.0)
        gm_tile = torch.where(gm_on, torch.floor(_uniform(gen, n, 100.0, 500.0)), 1.0)

        noise_on = _uniform(gen, ()) < cfg.gaussian_noise_prob
        noise_mean = torch.where(noise_on, _uniform(gen, n) - 0.5, 0.0)
        noise_std = torch.where(noise_on, _uniform(gen, n) * 100.0, 0.0)

        color_on = _uniform(gen, ()) < cfg.color_aug_prob
        brightness = torch.where(
            color_on, (1 - cfg.brightness / 2) + cfg.brightness * _uniform(gen, n), 1.0)
        contrast = torch.where(
            color_on, (1 - cfg.contrast / 2) + cfg.contrast * _uniform(gen, n), 1.0)
        hue = torch.where(color_on, _uniform(gen, n) * cfg.hue, 0.0)
        saturation = torch.where(
            color_on, (1 - cfg.saturation) + cfg.saturation * _uniform(gen, n), 1.0)

        return AugParams(fix_yx=fix, angle=angle, rrc_origin_yx=rrc_origin,
                         rrc_size_hw=rrc_size, flip=flip, noise_mean=noise_mean,
                         noise_std=noise_std, gm_ratio=gm_ratio, gm_tile=gm_tile,
                         brightness=brightness, contrast=contrast, hue=hue,
                         saturation=saturation)


def sample_labeled_params(gen: torch.Generator | None, batch_size: int,
                          src_size: int, fix_yx: torch.Tensor | None = None) -> AugParams:
    """Parameters of the labeled (probe/DETR) retina: the given fixation
    ``(B, 2)`` ``(y, x)`` or one drawn ~ U[0,1)² from ``gen``, no rotation,
    no crop, no photometrics; on ``fix_yx``'s or ``gen``'s device."""
    with span("retina.draw"):
        if fix_yx is None:
            fix_yx = _uniform(gen, (batch_size, 2))
        p = neutral_params(batch_size, src_size, fix_yx.device)
        return p._replace(fix_yx=fix_yx.to(torch.float32))


# ---------------------------------------------------------------------------
# Matmul mode


def _mip_levels(cfg: RetinaConfig) -> dict[int, int]:
    """Static crop→mip assignment: mip spacing ≈ half the glimpse lattice
    spacing at the median RandomResizedCrop zoom. Returns
    ``{crop_size: downscale_factor}`` (1 = native resolution)."""
    out = {}
    for crop in cfg.crop_sizes:
        spacing = crop / cfg.glimpse_size
        factor = 1
        while factor * 2 <= spacing * 0.66:
            factor *= 2
        out[crop] = factor
    return out


def build_pyramid(images: torch.Tensor, cfg: RetinaConfig) -> dict[int, torch.Tensor]:
    """Batched 2×-average mip chain ``(B, S, S, 3)`` uint8 →
    ``{factor: (B, M, 3M) bf16}``, channel-interleaved and unpadded.

    Each level averages the previous **bf16-rounded** level in f32 and
    rounds again, as the JAX chain does. The pyramid depends only on the
    source batch, so a train step builds it once for all its views.
    """
    with span("retina.pyramid"):
        factors = set(_mip_levels(cfg).values())
        m = images.to(torch.bfloat16)
        b, h, w, c = m.shape
        mips = {1: m.reshape(b, h, w * c)}
        f = 1
        while f < max(factors):
            m = (m.to(torch.float32).reshape(b, h // 2, 2, w // 2, 2, c)
                 .mean(dim=(2, 4)).to(torch.bfloat16))
            h //= 2
            w //= 2
            f *= 2
            mips[f] = m.reshape(b, h, w * c)
        return mips


def _window_size(crop_size: int, factor: int, mip_size: int) -> int:
    """Static side (mip px) of the window bounding one glimpse's source
    footprint: ``crop·√2`` for rotation plus hat margin, rounded up to 16
    with 16 px of slack for the 16-aligned window origin."""
    span = int(crop_size * 1.4143) + 6
    win = -(-(span // factor + 4 + 16) // 16) * 16
    return min(win, mip_size)


def _matmul_level_plan(p: AugParams, cfg: RetinaConfig, crop_size: int,
                       factor: int, mip_size: int, win: int):
    """Sampling plan of one level for the whole plan batch: window-relative
    mip coords ``rel_y``/``rel_x`` ``(B, P)``, window origins ``(B, 2)``
    int32 (floor-aligned to 16), grid-mask keep and out-of-bounds masks
    ``(B, P)``."""
    c = float(cfg.canvas_size)
    g = cfg.glimpse_size
    batch = p.fix_yx.shape[0]
    dev = p.fix_yx.device
    center = torch.full((2,), (c - 1) / 2, dtype=torch.float32, device=dev)
    base = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * (crop_size / g) - 0.5
    origin = p.fix_yx * (c - crop_size)                              # (B, 2)
    yy = (base[None, :, None] + origin[:, 0, None, None]).expand(batch, g, g)
    xx = (base[None, None, :] + origin[:, 1, None, None]).expand(batch, g, g)
    x_f = torch.where(p.flip[:, None, None], (c - 1.0) - xx, xx)
    coords = torch.stack([yy, x_f], dim=-1)                          # (B, g, g, 2)
    keep = image_ops.grid_mask_keep(coords, p.angle, p.fix_yx, p.gm_ratio,
                                    p.gm_tile)
    a = image_ops.rotate_coords(coords, p.angle, center)
    oob = (a < -0.5).any(-1) | (a > c - 0.5).any(-1)
    s = (p.rrc_origin_yx[:, None, None, :]
         + (a + 0.5) * (p.rrc_size_hw[:, None, None, :] / c) - 0.5)
    sm = (s + 0.5) / factor - 0.5 if factor > 1 else s              # mip coords
    sm = sm.reshape(batch, -1, 2)
    if win < mip_size:
        start = torch.floor(sm.amin(dim=1)) - 1.0
        start = start.clamp(0.0, mip_size - win).to(torch.int32)
        # floor-align to 16 (mip sizes and win are multiples of 16, so the
        # upper clamp stays aligned); the window's 16 px slack covers it
        start = torch.div(start, 16, rounding_mode="floor") * 16
    else:
        start = torch.zeros((batch, 2), dtype=torch.int32, device=dev)
    rel = sm - start.to(torch.float32)[:, None, :]
    return (rel[..., 0], rel[..., 1], start, keep.reshape(batch, -1),
            oob.reshape(batch, -1))


def sampler_args(mips: dict, p: AugParams, cfg: RetinaConfig) -> tuple:
    """The glimpse sampler's arguments for a plan batch: ``(level_mips,
    rel_y, rel_x, start, scale, wins, msizes)`` with ``rel_y``/``rel_x``/
    ``scale`` ``(B, L, P)`` float32 and ``start`` ``(B, L, 2)`` int32. The
    plan batch may be a ``V×`` multiple of the mip batch."""
    factors = _mip_levels(cfg)
    level_mips, wins, msizes = [], [], []
    rel_ys, rel_xs, starts, scales = [], [], [], []
    for crop_size in cfg.crop_sizes:
        factor = factors[crop_size]
        m = mips[factor]
        mip_size = m.shape[1]
        win = _window_size(crop_size, factor, mip_size)
        rel_y, rel_x, start, keep, oob = _matmul_level_plan(
            p, cfg, crop_size, factor, mip_size, win)
        level_mips.append(m)
        wins.append(win)
        msizes.append(mip_size)
        rel_ys.append(rel_y)
        rel_xs.append(rel_x)
        starts.append(start)
        # grid-mask keep and rotation out-of-bounds fold into one multiplier
        scales.append(keep * (1.0 - oob.to(torch.float32)))
    return (level_mips, torch.stack(rel_ys, 1), torch.stack(rel_xs, 1),
            torch.stack(starts, 1), torch.stack(scales, 1), wins, msizes)


def _matmul_batch(mips: dict, p: AugParams, cfg: RetinaConfig,
                  photometric: bool, generator: torch.Generator | None,
                  noise: torch.Tensor | None) -> torch.Tensor:
    """Sample every level of every plan row in one sampler call, then the
    photometric stages (view-major plan batches: see
    :func:`apply_retina_views`)."""
    g = cfg.glimpse_size
    levels = len(cfg.crop_sizes)
    batch = p.fix_yx.shape[0]
    v = glimpse_sample(*sampler_args(mips, p, cfg))          # (B, 3L, P)
    out = v.transpose(1, 2).reshape(batch, g, g, 3 * levels)

    if photometric:
        out = image_ops.add_gaussian_noise(out, p.noise_mean, p.noise_std,
                                           generator=generator, noise=noise)
        # ColorTwist as one product with the block-diagonal (3L × 3L)
        # matrix that applies each image's 3×3 twist within every level
        m3, b3 = image_ops.color_twist_matrix(p.brightness, p.contrast, p.hue,
                                              p.saturation)
        eye = torch.eye(levels, dtype=m3.dtype, device=m3.device)
        m_big = torch.kron(eye[None], m3)                     # (B, 3L, 3L)
        b_big = b3.repeat(1, levels)                          # (B, 3L)
        out = torch.einsum("bhwc,bdc->bhwd", out, m_big) + b_big[:, None, None, :]
    return out


# ---------------------------------------------------------------------------
# Fused and canvas modes


def _glimpse_sample_grid(cfg: RetinaConfig, crop_size: int,
                         device: torch.device | str) -> torch.Tensor:
    """Offsets ``(g, g, ss, ss, 2)`` of one level's supersampled output
    grid from the crop window's origin; ``ss = max(1, min(supersample,
    round(crop/g)))`` with Python's ``round`` (half to even), as in JAX."""
    g = cfg.glimpse_size
    step = crop_size / g
    ss = max(1, min(cfg.supersample, round(step)))
    f32 = dict(dtype=torch.float32, device=device)
    base = (torch.arange(g, **f32) + 0.5) * step - 0.5
    sub = ((torch.arange(ss, **f32) + 0.5) / ss - 0.5) * step
    yy = (base[:, None, None, None] + sub[None, None, :, None]).expand(g, g, ss, ss)
    xx = (base[None, :, None, None] + sub[None, None, None, :]).expand(g, g, ss, ss)
    return torch.stack([yy, xx], dim=-1)


def _color_twist(img: torch.Tensor, p: AugParams) -> torch.Tensor:
    """Each image's DALI ``ColorTwist`` over its last axis of 3 channels."""
    m, b = image_ops.color_twist_matrix(p.brightness, p.contrast, p.hue, p.saturation)
    lead = (img.shape[0],) + (1,) * (img.dim() - 2)
    return (torch.einsum("b...c,bdc->b...d", img, m) + b.reshape(lead + (3,)))


def _fused_batch(img: torch.Tensor, p: AugParams, cfg: RetinaConfig,
                 photometric: bool, noise: torch.Tensor | None) -> torch.Tensor:
    """The fused retina of ``img`` ``(B, S, S, 3)`` float32 →
    ``(B, g, g, 3L)`` (the JAX ``_fused_single``, batched)."""
    c = float(cfg.canvas_size)
    batch = img.shape[0]
    center = torch.full((2,), (c - 1) / 2, dtype=torch.float32, device=img.device)
    ext = (batch, 1, 1, 1, 1)
    glimpses = []
    for li, crop_size in enumerate(cfg.crop_sizes):
        grid = _glimpse_sample_grid(cfg, crop_size, img.device)
        origin = p.fix_yx * (c - crop_size)                  # DALI Crop: pos·(in − crop)
        coords = grid[None] + origin.reshape(ext + (2,))     # (B, g, g, ss, ss, 2)
        # the flip acts on the canvas before the pyramid (x → c − 1 − x)
        x = torch.where(p.flip.reshape(ext), (c - 1.0) - coords[..., 1], coords[..., 1])
        coords = torch.stack([coords[..., 0], x], dim=-1)
        keep = image_ops.grid_mask_keep(coords, p.angle, p.fix_yx, p.gm_ratio, p.gm_tile)
        a = image_ops.rotate_coords(coords, p.angle, center)
        oob = (a < -0.5).any(-1) | (a > c - 0.5).any(-1)
        s = (p.rrc_origin_yx.reshape(ext + (2,))
             + (a + 0.5) * (p.rrc_size_hw.reshape(ext + (2,)) / c) - 0.5)
        v = image_ops.bilinear_sample(img, s, fill_value=0.0, fill_mask=oob)
        v = (v * keep[..., None]).mean(dim=(3, 4))          # (B, g, g, 3)
        if photometric:
            v = image_ops.add_gaussian_noise(v, p.noise_mean, p.noise_std,
                                             noise=noise[..., 3 * li:3 * li + 3])
        glimpses.append(v)
    out = torch.cat(glimpses, dim=-1)                       # scale-major channels
    if photometric:
        levels = len(cfg.crop_sizes)
        out = _color_twist(out.reshape(out.shape[:-1] + (levels, 3)), p).reshape(out.shape)
    return out


def _canvas_grid(c: int, device: torch.device | str) -> torch.Tensor:
    """Integer pixel coordinates ``(c, c, 2)`` ``(y, x)`` of the canvas."""
    ar = torch.arange(c, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    return torch.stack([gy, gx], dim=-1)


def _rotated_canvas(img: torch.Tensor, angle: torch.Tensor, c: int,
                    warp=None) -> torch.Tensor:
    """``img`` rotated by ``angle`` about the canvas centre (inverse warp,
    zero fill outside the canvas) into ``(B, c, c, 3)``; ``warp`` maps the
    rotated canvas coordinates into the source (the RandomResizedCrop)."""
    grid = _canvas_grid(c, img.device).expand((img.shape[0], c, c, 2))
    center = torch.full((2,), (c - 1) / 2, dtype=torch.float32, device=img.device)
    a = image_ops.rotate_coords(grid, angle, center)
    oob = (a < -0.5).any(-1) | (a > c - 0.5).any(-1)
    return image_ops.bilinear_sample(img, a if warp is None else warp(a),
                                     fill_value=0.0, fill_mask=oob)


def _canvas_batch(img: torch.Tensor, p: AugParams, cfg: RetinaConfig,
                  photometric: bool, noise: torch.Tensor | None) -> torch.Tensor:
    """The DALI-faithful canvas retina of ``img`` ``(B, S, S, 3)`` float32
    → ``(B, g, g, 3L)`` (the JAX ``_canvas_single``, batched)."""
    c = cfg.canvas_size
    ext = (img.shape[0], 1, 1, 2)
    canvas = _rotated_canvas(
        img, p.angle, c,
        lambda a: (p.rrc_origin_yx.reshape(ext)
                   + (a + 0.5) * (p.rrc_size_hw.reshape(ext) / c) - 0.5))
    if photometric:
        grid = _canvas_grid(c, img.device).expand(canvas.shape[:3] + (2,))
        keep = image_ops.grid_mask_keep(grid, p.angle, p.fix_yx, p.gm_ratio, p.gm_tile)
        canvas = image_ops.add_gaussian_noise(canvas * keep[..., None], p.noise_mean,
                                              p.noise_std, noise=noise)
    canvas = image_ops.hflip(canvas, p.flip)
    if photometric:
        canvas = _color_twist(canvas, p)
    g = cfg.glimpse_size
    return torch.cat([image_ops.crop_resize_with_filter(canvas, p.fix_yx * (c - crop),
                                                        (crop, crop), (g, g))
                      for crop in cfg.crop_sizes], dim=-1)


# ---------------------------------------------------------------------------
# Public pipelines


def noise_shape(cfg: RetinaConfig, batch: int) -> tuple[int, ...]:
    """The standard-normal draw one photometric view of ``batch`` images
    adds: ``(B, g, g, 3L)`` glimpse noise in the ``matmul`` and ``fused``
    modes (``fused`` adds level ``l``'s ``[..., 3l:3l+3]`` before the
    colour twist), ``(B, c, c, 3)`` canvas noise in ``canvas`` mode."""
    if cfg.mode == "canvas":
        return (batch, cfg.canvas_size, cfg.canvas_size, 3)
    return (batch, cfg.glimpse_size, cfg.glimpse_size, cfg.num_channels)


def apply_retina(images: torch.Tensor | None, params: AugParams,
                 cfg: RetinaConfig, photometric: bool,
                 pyramid: dict | None = None,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """One retina view of a batch → ``(B, g, g, 3L)`` float32 NHWC glimpses.

    ``matmul`` mode: pass ``pyramid=build_pyramid(images, cfg)`` when
    running several views of the same batch. ``fused`` and ``canvas`` read
    ``images`` (uint8 or float, cast to float32) and ignore ``pyramid``.
    With ``photometric``, the standard-normal noise of shape
    :func:`noise_shape` is drawn from ``generator`` or given as ``noise``.
    """
    with span("retina.sample"):
        if cfg.mode == "matmul":
            if pyramid is None:
                pyramid = build_pyramid(images, cfg)
            return _matmul_batch(pyramid, params, cfg, photometric, generator, noise)
        single = {"fused": _fused_batch, "canvas": _canvas_batch}.get(cfg.mode)
        if single is None:
            raise ValueError(f"unknown retina mode {cfg.mode!r} (matmul, fused or canvas)")
        images = images.to(torch.float32)
        if photometric and noise is None:
            with span("retina.draw"):
                noise = torch.randn(noise_shape(cfg, images.shape[0]), generator=generator,
                                    device=images.device)
        return single(images, params, cfg, photometric, noise)


def apply_retina_views(pyramid: dict, params_views: AugParams,
                       cfg: RetinaConfig, photometric: bool,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """All ``V`` views of one source batch in one sampler call (``matmul``
    mode only, as in the JAX package).

    ``params_views`` has leading dim ``V·B``, view-major (plan row
    ``v·B + i`` samples source image ``i``); ``noise``, when given, is
    ``(V·B, g, g, 3L)`` in the same order. Returns ``(V·B, g, g, 3L)``.
    """
    if cfg.mode != "matmul":
        raise ValueError("apply_retina_views requires the matmul retina")
    with span("retina.sample"):
        return _matmul_batch(pyramid, params_views, cfg, photometric, generator, noise)


def unlabeled_glimpses(images: torch.Tensor, params: AugParams, cfg: RetinaConfig,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """A SimCLR augmentation view → ``(B, g, g, 3L)`` float32 glimpse stacks
    (``UnlabeledFoveatedRetinalProcessor``, ``NVIDIA_DALI_Pipelines.py:
    444-479``, plus the channel stacking of ``SimCLR.py:24``): the
    photometric view, its noise drawn from ``generator`` or given as
    ``noise``."""
    return apply_retina(images, params, cfg, True, generator=generator, noise=noise)


def labeled_glimpses(images: torch.Tensor, params: AugParams,
                     cfg: RetinaConfig) -> torch.Tensor:
    """A labeled view, no photometrics (``LabeledFoveatedRetinalProcessor``,
    ``NVIDIA_DALI_Pipelines.py:523-543``) → ``(B, g, g, 3L)``."""
    return apply_retina(images, params, cfg, False)


def foveated_pyramid(image: torch.Tensor, fix_yx: torch.Tensor, angle: torch.Tensor,
                     cfg: RetinaConfig | None = None):
    """The visualisation pipeline of one image ``(S, S, 3)``: its canvas
    (resized to ``c`` if need be) rotated by ``angle`` about the centre, and
    every crop (``c`` and the configured sizes) at ``fix_yx`` ``(2,)`` with
    its ``g × g`` resize. Returns ``(crops, resizes)``. A crop's origin is
    ``fix·(c − crop)`` rounded half to even and clamped into the canvas,
    as ``lax.dynamic_slice`` clamps it."""
    cfg = cfg or RetinaConfig()
    c = cfg.canvas_size
    img = image.to(torch.float32)[None]
    if img.shape[1] != c:
        img = image_ops.resize_with_filter(img, (c, c))
    angle = torch.as_tensor(angle, dtype=torch.float32, device=img.device).reshape(1)
    canvas = _rotated_canvas(img, angle, c)[0]
    fix_yx = torch.as_tensor(fix_yx, dtype=torch.float32, device=img.device)
    g = cfg.glimpse_size
    crops, resizes = [], []
    for crop_size in (c,) + tuple(cfg.crop_sizes):
        oy, ox = torch.round(fix_yx * (c - crop_size)).to(torch.int64).clamp(
            0, c - crop_size).tolist()
        crop = canvas[oy:oy + crop_size, ox:ox + crop_size]
        crops.append(crop)
        resizes.append(image_ops.resize_with_filter(crop[None], (g, g))[0])
    return crops, resizes
