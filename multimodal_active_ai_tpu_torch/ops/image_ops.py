"""Pointwise and coordinate image operations of the retina.

Port of ``multimodal_active_ai_tpu/ops/image_ops.py`` (the parts the matmul
retina uses): rotation of sampling coordinates, the DALI ``ColorTwist``
matrix, the ``GridMask`` keep indicator, additive Gaussian noise and the
horizontal flip. Images are float32 NHWC in the raw 0..255 range, pixel
centres at integer coordinates, coordinates ordered ``(y, x)``.

All parameters are per image: tensors shaped ``(B,)`` broadcast against
coordinate tensors shaped ``(B, ..., 2)``.
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
