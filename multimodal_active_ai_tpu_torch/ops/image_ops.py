"""Pointwise and coordinate image operations of the retina.

Port of ``multimodal_active_ai_tpu/ops/image_ops.py``: rotation of
sampling coordinates, the DALI ``ColorTwist`` matrix, the ``GridMask`` keep
indicator, additive Gaussian noise and the horizontal flip (the matmul
retina's), and the edge-clamped bilinear gather and the antialiased
triangle-filter resizes (the ``fused`` and ``canvas`` retinas'). Images are
float32 NHWC in the raw 0..255 range, pixel centres at integer coordinates,
coordinates ordered ``(y, x)``.

All parameters are per image: tensors shaped ``(B,)`` broadcast against
coordinate tensors shaped ``(B, ..., 2)``. The JAX functions take one
image and are vmapped; these take the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# RGB <-> YIQ, the linear hue/saturation space DALI uses. The inverse is
# computed exactly so a neutral twist (b=c=s=1, h=0) is the identity.
_RGB2YIQ_NP = np.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.322],
                        [0.211, -0.523, 0.312]], dtype=np.float64)
_YIQ2RGB_NP = np.linalg.inv(_RGB2YIQ_NP)


def _per_image(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a ``(B,)`` parameter to broadcast over ``like``'s trailing
    dims (``like`` is ``(B, ...)``)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def rotate_coords(coords_yx: torch.Tensor, angle_deg: torch.Tensor,
                  center_yx: torch.Tensor) -> torch.Tensor:
    """Map output coords of a rotation about ``center_yx`` to input coords
    (inverse warp; positive angles rotate counter-clockwise).

    ``coords_yx``: ``(B, ..., 2)``; ``angle_deg``: ``(B,)``.
    """
    theta = _per_image(angle_deg * (math.pi / 180.0), coords_yx[..., 0])
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    rel = coords_yx - center_yx
    y, x = rel[..., 0], rel[..., 1]
    xi = cos * x - sin * y
    yi = sin * x + cos * y
    return torch.stack([yi, xi], dim=-1) + center_yx


def color_twist_matrix(brightness: torch.Tensor, contrast: torch.Tensor,
                       hue_deg: torch.Tensor, saturation: torch.Tensor):
    """Per-image DALI ``ColorTwist`` as ``out = M @ rgb + b``.

    Hue rotation and saturation scale act on (I, Q) in YIQ space;
    contrast pivots at 128, brightness scales. Parameters are ``(B,)``;
    returns ``M`` ``(B, 3, 3)`` and ``b`` ``(B, 3)``, float32.
    """
    h = hue_deg * (math.pi / 180.0)
    cos_h = torch.cos(h)
    sin_h = torch.sin(h)
    one = torch.ones_like(cos_h)
    zero = torch.zeros_like(cos_h)
    hs = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, saturation * cos_h, -saturation * sin_h], -1),
        torch.stack([zero, saturation * sin_h, saturation * cos_h], -1),
    ], -2)                                                   # (B, 3, 3)
    dev = hs.device
    yiq2rgb = torch.as_tensor(_YIQ2RGB_NP, dtype=torch.float32, device=dev)
    rgb2yiq = torch.as_tensor(_RGB2YIQ_NP, dtype=torch.float32, device=dev)
    m = yiq2rgb @ hs @ rgb2yiq
    m = (brightness * contrast)[:, None, None] * m
    offset = (brightness * 128.0 * (1.0 - contrast))[:, None].expand(-1, 3)
    return m, offset


def grid_mask_keep(coords_yx: torch.Tensor, angle_deg: torch.Tensor,
                   shift_yx: torch.Tensor, ratio: torch.Tensor,
                   tile: torch.Tensor) -> torch.Tensor:
    """DALI ``GridMask`` keep indicator (1 keep, 0 masked) at coordinates.

    Square cutouts of side ``ratio * tile`` with period ``tile``, rotated
    by ``angle`` and shifted by ``shift_yx`` (the reference wires the
    fixation position into the shift); ``ratio == 0`` masks nothing.
    ``coords_yx``: ``(B, ..., 2)``; ``shift_yx``: ``(B, 2)``; the rest
    ``(B,)``.
    """
    like = coords_yx[..., 0]
    theta = _per_image(angle_deg * (math.pi / 180.0), like)
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    y = coords_yx[..., 0] - _per_image(shift_yx[:, 0], like)
    x = coords_yx[..., 1] - _per_image(shift_yx[:, 1], like)
    xr = cos * x - sin * y
    yr = sin * x + cos * y
    tile = _per_image(torch.clamp(tile, min=1.0), like)
    ratio = _per_image(ratio, like)
    fx = _floor_mod(xr, tile)
    fy = _floor_mod(yr, tile)
    cut = ratio * tile
    masked = (fx < cut) & (fy < cut) & (ratio > 0.0)
    return torch.where(masked, 0.0, 1.0)


def _floor_mod(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Floored modulo (the result takes the divisor's sign), computed as
    ``fmod`` plus a sign fix-up, the way ``jnp.mod`` does."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def add_gaussian_noise(img: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """``img + N(0, 1)·std + mean`` per image (DALI ``NormalDistribution``).

    The standard-normal draw comes from ``generator``, or is given whole as
    ``noise`` (same shape as ``img``), so a test can feed another
    framework's exact draws.
    """
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, dtype=img.dtype,
                            device=img.device)
    elif noise.shape != img.shape:
        raise ValueError(f"noise {tuple(noise.shape)} != image {tuple(img.shape)}")
    return img + noise * _per_image(std, img) + _per_image(mean, img)


def hflip(img: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    """Per-image horizontal flip of an NHWC batch (DALI ``ops.Flip``)."""
    return torch.where(_per_image(do_flip, img), img.flip(2), img)


def bilinear_sample(img: torch.Tensor, coords_yx: torch.Tensor,
                    fill_value: float | None = None,
                    fill_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinearly sample ``img`` ``(B, H, W, C)`` at float coordinates
    ``(B, ..., 2)`` ``(y, x)`` → ``(B, ..., C)``.

    The JAX function's edge handling: the top-left tap is clamped into the
    image and the other tap is the clamped next pixel, with the weights of
    the unclamped coordinate. Where ``fill_mask`` is True the sample is
    ``fill_value`` (DALI ``Rotate``'s zero fill outside the canvas).
    """
    b, h, w, c = img.shape
    y, x = coords_yx[..., 0], coords_yx[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=img.device).reshape((b,) + (1,) * (y.dim() - 1))

    def gather(yi, xi):
        return flat[rows, yi * w + xi]

    out = (gather(y0i, x0i) * (1 - wy) * (1 - wx) + gather(y0i, x1i) * (1 - wy) * wx
           + gather(y1i, x0i) * wy * (1 - wx) + gather(y1i, x1i) * wy * wx)
    if fill_mask is not None:
        out = torch.where(fill_mask[..., None],
                          torch.tensor(fill_value or 0.0, dtype=out.dtype, device=out.device),
                          out)
    return out


def _triangle_weights(input_size: int, output_size: int, scale: float,
                      translation: torch.Tensor) -> torch.Tensor:
    """Per-image weights ``(B, input_size, output_size)`` of one axis of
    the antialiased linear ``jax.image.scale_and_translate``
    (``jax/_src/image/scale.py:compute_weight_mat``): output sample ``o``
    reads input position ``(o + 0.5 − translation)/scale − 0.5``, the
    triangle kernel is widened by ``1/scale`` when downscaling, each
    output's weights are normalised to sum to 1, and an output whose
    position falls outside ``[−0.5, input_size − 0.5]`` gets none.
    ``translation`` is ``(B,)`` float32."""
    dev = translation.device
    f32 = dict(dtype=torch.float32, device=dev)
    inv_scale = 1.0 / torch.tensor(scale, **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(output_size, **f32) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)               # (B, out)
    x = (torch.abs(sample_f[:, None, :] - torch.arange(input_size, **f32)[None, :, None])
         / kernel_scale)
    weights = torch.clamp(1 - torch.abs(x), min=0)
    total = weights.sum(dim=1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0)


def _scale_and_translate(img: torch.Tensor, out_hw: tuple[int, int],
                         scale_hw: tuple[float, float],
                         translation_yx: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate(method='linear', antialias=True)``
    over the spatial axes of ``img`` ``(B, H, W, C)``, with per-image
    ``translation_yx`` ``(B, 2)``: two products with the separable weight
    matrices."""
    _, h, w, _ = img.shape
    wy = _triangle_weights(h, out_hw[0], scale_hw[0], translation_yx[:, 0])
    wx = _triangle_weights(w, out_hw[1], scale_hw[1], translation_yx[:, 1])
    rows = torch.einsum("bhwc,bho->bowc", img, wy)
    return torch.einsum("bowc,bwp->bopc", rows, wx)


def _f32_scale(out: int, size: int) -> float:
    """``jnp.array(out / size, float32)``: the scale rounded to float32."""
    return float(np.float32(out / size))


def resize_with_filter(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased linear (triangle-filter) resize of ``(B, H, W, C)`` to
    ``out_hw``, DALI ``ops.Resize``'s default. The translation is zero:
    ``scale_and_translate`` already samples at half-pixel centres (an extra
    ``0.5·(scale − 1)`` term shifts every downscale by half an output
    pixel; see the JAX docstring)."""
    b, h, w, _ = img.shape
    scale = (_f32_scale(out_hw[0], h), _f32_scale(out_hw[1], w))
    zeros = torch.zeros((b, 2), dtype=torch.float32, device=img.device)
    return _scale_and_translate(img, out_hw, scale, zeros)


def crop_resize_with_filter(img: torch.Tensor, origin_yx: torch.Tensor,
                            crop_hw: tuple[int, int],
                            out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop of static size ``crop_hw`` at the per-image, possibly fractional
    ``origin_yx`` ``(B, 2)``, then the antialiased resize to ``out_hw``
    (DALI ``Crop(crop_pos)`` → ``Resize``). The origin folds into the
    resize's translation, ``−origin·scale``, so nothing snaps to a pixel."""
    scale = (_f32_scale(out_hw[0], crop_hw[0]), _f32_scale(out_hw[1], crop_hw[1]))
    scale_t = torch.tensor(scale, dtype=torch.float32, device=img.device)
    return _scale_and_translate(img, out_hw, scale, -origin_yx * scale_t)
