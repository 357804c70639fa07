"""The PyTorch port's retina against the JAX package's, on equal inputs.

Inputs come from numpy seeds (or from ``jax.random`` draws handed across as
numpy), so both sides see the same numbers. Covered: the image ops, the
glimpse sampler's plain version against ``glimpse_sample_xla`` and the
Pallas kernel (interpret mode), ``build_pyramid``, the per-level plan and
whole ``apply_retina`` / ``apply_retina_views`` views, and the import
boundary (no JAX inside the port).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.ops import image_ops as jio
from multimodal_active_ai_tpu.ops import pallas_retina as jpr
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import image_ops as tio
from multimodal_active_ai_tpu_torch.ops import retina as tr

# Two geometries: the 64-canvas test config of tests/test_train_step.py
# (every level reads the native mip), and a 256-canvas one whose crops map
# to mip factors 4/2/1/1 with windows smaller than their mips.
GEOMETRIES = {
    "canvas64": dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30)),
    "canvas256": dict(canvas_size=256, glimpse_size=8, crop_sizes=(96, 48, 24, 8)),
}
B = 4

# Same algorithm, same bf16 rounding of the y weights, f32 sums taken in
# another order: error ~ win taps x 255 x f32 eps, well under 2e-3.
PLAIN_TOL = dict(rtol=1e-5, atol=2e-3)
# The Pallas kernel also rounds its products to bf16 (the tolerance of
# tests/test_pallas_retina.py).
PALLAS_TOL = dict(rtol=1e-2, atol=1e-1)
# Whole views: the coordinate chain runs through f32 sin/cos, which XLA
# and torch may round 1 ulp apart (~1e-5 px, ~3e-3 in a 0..255 pixel);
# the colour twist scales values by up to ~2. Almost every element agrees
# to VIEW_TOL. A coordinate 1 ulp apart can, rarely, move a y weight across
# a bf16 rounding step (2^-8 relative): up to 255 x 2^-8 x 2 ~ 2 in the
# output, so every element agrees to VIEW_BF16_STEP and at most 1% may
# need it (measured: 0.06% of a 64-canvas view, 0.4% of the small
# 256-canvas one).
VIEW_TOL = dict(rtol=1e-4, atol=2e-2)
VIEW_BF16_STEP = 2.0


def assert_views_close(got, ref, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0, atol=VIEW_BF16_STEP, err_msg=name)
    loose = ~np.isclose(got, ref, **VIEW_TOL)
    assert loose.mean() <= 1e-2, (name, int(loose.sum()), loose.size)


def _t(x):
    return torch.from_numpy(np.array(x))


# the JAX side jitted, so each reference costs one compile instead of an
# op-by-op dispatch
_j_sample = jax.jit(jr.sample_unlabeled_params, static_argnums=(1, 2, 3))
_j_retina = jax.jit(jr.apply_retina, static_argnames=("cfg", "photometric"))
_j_views = jax.jit(jr.apply_retina_views, static_argnames=("cfg", "photometric"))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _j_noise(key, b, shape):
    """The standard-normal draws JAX's retina adds: one per image, from
    ``split(key, b)``."""
    return jax.vmap(lambda k: jax.random.normal(k, shape))(jax.random.split(key, b))


def _jax_cfg(name, **kw):
    return jr.RetinaConfig(supersample=1, use_pallas=False, **GEOMETRIES[name], **kw)


def _torch_cfg(name, **kw):
    return tr.RetinaConfig(**GEOMETRIES[name], **kw)


def _to_torch_params(p) -> tr.AugParams:
    return tr.AugParams(*[_t(x) for x in p])


def _images(seed, size):
    return np.random.default_rng(seed).integers(0, 256, (B, size, size, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# image ops


def test_rotate_coords_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-10, 80, (B, 7, 5, 2)).astype(np.float32)
    angle = rng.uniform(-80, 80, (B,)).astype(np.float32)
    center = np.array([31.5, 31.5], np.float32)
    ref = jax.vmap(jio.rotate_coords, (0, 0, None))(coords, angle, center)
    got = tio.rotate_coords(_t(coords), _t(angle), _t(center))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_color_twist_matrix_matches_jax():
    rng = np.random.default_rng(1)
    b, c, h, s = (rng.uniform(0.5, 1.5, (B,)).astype(np.float32) for _ in range(4))
    h = h * 60.0
    m_ref, o_ref = jax.vmap(jio.color_twist_matrix)(b, c, h, s)
    m, o = tio.color_twist_matrix(_t(b), _t(c), _t(h), _t(s))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5, atol=1e-4)


def test_grid_mask_keep_matches_jax():
    rng = np.random.default_rng(2)
    coords = rng.uniform(-300, 900, (B, 30, 30, 2)).astype(np.float32)
    angle = rng.uniform(-80, 80, (B,)).astype(np.float32)
    shift = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    ratio = np.array([0.0, 0.2, 0.35, 0.5], np.float32)
    tile = np.floor(rng.uniform(100, 500, (B,))).astype(np.float32)
    ref = jax.vmap(jio.grid_mask_keep)(coords, angle, shift, ratio, tile)
    got = tio.grid_mask_keep(_t(coords), _t(angle), _t(shift), _t(ratio), _t(tile))
    # an indicator: allow no more than a handful of f32 boundary flips
    assert (got.numpy() != np.asarray(ref)).mean() < 1e-3
    assert got[0].min() == 1.0            # ratio 0 masks nothing
    assert 0.0 < got[3].mean() < 1.0      # ratio 0.5 masks something


def test_add_gaussian_noise_with_given_draws_matches_jax():
    key = jax.random.PRNGKey(3)
    img = np.random.default_rng(3).uniform(0, 255, (B, 30, 30, 12)).astype(np.float32)
    mean = np.array([0.0, -0.3, 0.2, 0.4], np.float32)
    std = np.array([0.0, 10.0, 50.0, 99.0], np.float32)
    keys = jax.random.split(key, B)
    ref = jax.vmap(jio.add_gaussian_noise)(img, keys, mean, std)
    noise = jax.vmap(lambda k: jax.random.normal(k, img.shape[1:]))(keys)
    got = tio.add_gaussian_noise(_t(img), _t(mean), _t(std), noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-3)
    gen = torch.Generator().manual_seed(0)
    drawn = tio.add_gaussian_noise(_t(img), _t(mean), _t(std), generator=gen)
    assert torch.equal(drawn[0], _t(img)[0])   # std 0, mean 0: unchanged


def test_hflip_matches_jax():
    img = np.random.default_rng(4).uniform(0, 255, (B, 6, 5, 3)).astype(np.float32)
    flip = np.array([True, False, True, False])
    ref = jax.vmap(jio.hflip)(img, flip)
    np.testing.assert_array_equal(tio.hflip(_t(img), _t(flip)).numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the sampler's plain version against the JAX sampler


def _sampler_case(seed, b, levels, p, views=1, tail=False):
    """``levels`` = [(M, win), ...]; y starts 8-aligned (the Pallas
    contract); rel coords reach past both window edges."""
    rng = np.random.default_rng(seed)
    mips, rel_y, rel_x, start = [], [], [], []
    for m, win in levels:
        mips.append(jnp.asarray(rng.uniform(0, 255, (b, m, 3 * m)), jnp.bfloat16))
        sy = (rng.integers(0, m - win + 1, (views * b,)) // 8) * 8
        sx = rng.integers(0, m - win + 1, (views * b,))
        ry = rng.uniform(-2.0, win + 1.0, (views * b, p))
        rx = rng.uniform(-2.0, win + 1.0, (views * b, p))
        if tail:   # windows flush with the mip's end, taps on the last row
            sy[:] = m - win
            sx[:] = m - win
            ry[:, : p // 2] = win - 1.0
            rx[:, : p // 4] = win - 1.0
        start.append(np.stack([sy, sx], -1))
        rel_y.append(ry)
        rel_x.append(rx)
    rel_y = np.stack(rel_y, 1).astype(np.float32)
    rel_x = np.stack(rel_x, 1).astype(np.float32)
    start = np.stack(start, 1).astype(np.int32)
    scale = rng.uniform(0, 1, rel_y.shape).astype(np.float32)
    wins = tuple(w for _, w in levels)
    msizes = tuple(m for m, _ in levels)
    return tuple(mips), rel_y, rel_x, start, scale, wins, msizes


SAMPLER_CASES = {
    "multi_level": dict(seed=0, b=3, levels=[(64, 32), (32, 16), (16, 16)], p=20),
    "tail_clamp": dict(seed=1, b=3, levels=[(64, 32), (32, 16)], p=24, tail=True),
    "column_window": dict(seed=2, b=2, levels=[(640, 80)], p=12),
    "multi_view": dict(seed=3, b=3, levels=[(32, 16), (16, 8)], p=10, views=2),
}


@pytest.fixture(scope="module", params=sorted(SAMPLER_CASES))
def sampler_case(request):
    case = _sampler_case(**SAMPLER_CASES[request.param])
    mips, rel_y, rel_x, start, scale, wins, msizes = case
    j_args = (mips, jnp.asarray(rel_y), jnp.asarray(rel_x), jnp.asarray(start),
              jnp.asarray(scale), wins, msizes)
    xla = np.asarray(jpr.glimpse_sample_xla(*j_args))
    pallas = np.asarray(jpr.glimpse_sample(*j_args, interpret=True))
    t_mips = [_t(np.asarray(m.astype(jnp.float32))).to(torch.bfloat16) for m in mips]
    plain = tgs.glimpse_sample_plain(t_mips, _t(rel_y), _t(rel_x), _t(start),
                                      _t(scale), wins, msizes)
    wrapped = tgs.glimpse_sample(t_mips, _t(rel_y), _t(rel_x), _t(start),
                                 _t(scale), wins, msizes)
    return request.param, plain, wrapped, xla, pallas


def test_glimpse_sample_plain_matches_xla(sampler_case):
    name, plain, _, xla, _ = sampler_case
    assert plain.shape == xla.shape and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), xla, **PLAIN_TOL, err_msg=name)


def test_glimpse_sample_plain_matches_pallas_interpret(sampler_case):
    name, plain, _, _, pallas = sampler_case
    np.testing.assert_allclose(plain.numpy(), pallas, **PALLAS_TOL, err_msg=name)


def test_glimpse_sample_wrapper_takes_plain_version_on_cpu(sampler_case):
    _, plain, wrapped, _, _ = sampler_case
    assert torch.equal(wrapped, plain)


def test_glimpse_sample_rejects_bad_geometry():
    mips, rel_y, rel_x, start, scale, wins, msizes = _sampler_case(
        seed=0, b=3, levels=[(32, 16)], p=4)
    t_mip = [torch.zeros((3, 32, 96), dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="multiple"):
        tgs.glimpse_sample(t_mip, _t(rel_y)[:2], _t(rel_x)[:2], _t(start)[:2],
                           _t(scale)[:2], wins)
    with pytest.raises(ValueError, match="window"):
        tgs.glimpse_sample(t_mip, _t(rel_y), _t(rel_x), _t(start), _t(scale), (64,))


# ---------------------------------------------------------------------------
# pyramid, plan and whole views


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def geometry(request):
    name = request.param
    jcfg = _jax_cfg(name, grid_mask_prob=1.0)
    tcfg = _torch_cfg(name, grid_mask_prob=1.0)
    images = _images(10, jcfg.canvas_size)
    jpyr = jr.build_pyramid(jnp.asarray(images), jcfg)
    tpyr = tr.build_pyramid(_t(images), tcfg)
    return name, jcfg, tcfg, images, jpyr, tpyr


def test_build_pyramid_matches_jax_exactly(geometry):
    _, jcfg, _, _, jpyr, tpyr = geometry
    assert sorted(jpyr) == sorted(tpyr)
    for f, t_mip in tpyr.items():
        j = np.asarray(jpyr[f].astype(jnp.float32))
        b, m, w = t_mip.shape
        assert t_mip.dtype == torch.bfloat16 and w == 3 * m
        np.testing.assert_array_equal(t_mip.float().numpy(), j[:, :, :w])


def test_sample_unlabeled_params_ranges(geometry):
    _, _, tcfg, _, _, _ = geometry
    gen = torch.Generator().manual_seed(0)
    p = tr.sample_unlabeled_params(gen, 256, tcfg.canvas_size, tcfg)
    assert set(p._fields) == set(jr.AugParams._fields)
    assert p.fix_yx.shape == (256, 2) and p.flip.dtype == torch.bool
    assert float(p.angle.abs().max()) <= 80.0
    assert (p.rrc_size_hw >= 1).all() and (p.rrc_size_hw <= tcfg.canvas_size).all()
    assert ((p.gm_ratio >= 0.2) & (p.gm_ratio <= 0.5)).all()   # grid mask forced on
    # the noise and colour gates are one draw per batch: all on or all off
    assert p.noise_std.eq(0).all() or p.noise_std.gt(0).all()
    assert p.hue.eq(0).all() or p.hue.gt(0).all()


def _jax_views(jcfg, images, jpyr, key, v):
    """``v`` views' params, noise draws and glimpses from the JAX retina."""
    b = images.shape[0]
    g = jcfg.glimpse_size
    params, noise, outs = [], [], []
    for k in jax.random.split(key, v):
        kp, kn = jax.random.split(k)
        p = _j_sample(kp, b, jcfg.canvas_size, jcfg)
        outs.append(np.asarray(_j_retina(None, p, kn, cfg=jcfg, photometric=True,
                                         pyramid=jpyr)))
        params.append(p)
        noise.append(np.asarray(_j_noise(kn, b, (g, g, jcfg.num_channels))))
    return params, noise, outs


def test_matmul_level_plan_matches_jax(geometry):
    _, jcfg, tcfg, images, jpyr, tpyr = geometry
    p = _j_sample(jax.random.PRNGKey(5), B, jcfg.canvas_size, jcfg)
    tp = _to_torch_params(p)
    factors = jr._mip_levels(jcfg)
    assert factors == tr._mip_levels(tcfg)
    for crop in jcfg.crop_sizes:
        f = factors[crop]
        m = tpyr[f].shape[1]
        win = jr._window_size(crop, f, m)
        assert win == tr._window_size(crop, f, m)
        ref = jax.vmap(lambda q: jr._matmul_level_plan(
            q, jcfg, crop_size=crop, factor=f, mip_size=m, win=win))(p)
        got = tr._matmul_level_plan(tp, tcfg, crop, f, m, win)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        for i in (0, 1):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                       rtol=1e-5, atol=1e-3)
        for i in (3, 4):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(ref[i]).reshape(B, -1))


def test_apply_retina_matches_jax(geometry):
    name, jcfg, tcfg, images, jpyr, tpyr = geometry
    params, noise, outs = _jax_views(jcfg, images, jpyr, jax.random.PRNGKey(6), 2)
    for p, nz, ref in zip(params, noise, outs):
        got = tr.apply_retina(None, _to_torch_params(p), tcfg, True,
                              pyramid=tpyr, noise=_t(nz))
        assert got.shape == ref.shape == (B, jcfg.glimpse_size, jcfg.glimpse_size,
                                          jcfg.num_channels)
        assert_views_close(got, ref, name)
    # without a pyramid the view builds its own; non-photometric skips noise
    p0 = _to_torch_params(params[0])
    plain_view = tr.apply_retina(_t(images), p0, tcfg, False)
    ref0 = np.asarray(_j_retina(jnp.asarray(images), params[0],
                                jax.random.PRNGKey(0), cfg=jcfg, photometric=False))
    assert_views_close(plain_view, ref0, name)


def test_apply_retina_views_matches_jax(geometry):
    name, jcfg, tcfg, images, jpyr, tpyr = geometry
    v = 3
    keys = jax.random.split(jax.random.PRNGKey(7), v)
    ps = [_j_sample(k, B, jcfg.canvas_size, jcfg) for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.concatenate(xs), *ps)
    view_keys = jax.random.split(jax.random.PRNGKey(8), v)
    ref = np.asarray(_j_views(jpyr, stacked, view_keys, cfg=jcfg, photometric=True))
    g = jcfg.glimpse_size
    noise = np.concatenate([np.asarray(_j_noise(k, B, (g, g, jcfg.num_channels)))
                            for k in view_keys])
    got = tr.apply_retina_views(tpyr, _to_torch_params(stacked), tcfg, True,
                                noise=_t(noise))
    assert got.shape == (v * B, g, g, jcfg.num_channels)
    assert_views_close(got, ref, name)


def test_apply_retina_draws_from_generator():
    tcfg = _torch_cfg("canvas64")
    images = _t(_images(11, 64))
    pyr = tr.build_pyramid(images, tcfg)

    def view(seed):
        gen = torch.Generator().manual_seed(seed)
        p = tr.sample_unlabeled_params(gen, B, 64, tcfg)
        return tr.apply_retina(None, p, tcfg, True, pyramid=pyr, generator=gen)

    a, b, c = view(0), view(0), view(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_unported_retina_modes_raise():
    """The ``fused`` and ``canvas`` modes are ported
    (``test_torch_port_retina_modes.py``); ``apply_retina_views`` refuses
    them with the JAX package's ``ValueError``, as its JAX twin does."""
    for mode in ("fused", "canvas"):
        cfg = tr.RetinaConfig(canvas_size=64, mode=mode)
        pyr = tr.build_pyramid(_t(_images(0, 64)), tr.RetinaConfig(canvas_size=64))
        with pytest.raises(ValueError, match="requires the matmul retina"):
            tr.apply_retina_views(pyr, tr.neutral_params(B, 64), cfg, False)
        with pytest.raises(ValueError, match="requires the matmul retina"):
            jr.apply_retina_views(None, None, None, _jax_cfg("canvas64", mode=mode), False)


# ---------------------------------------------------------------------------
# the import boundary


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, ".")
import multimodal_active_ai_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax",
                                            "multimodal_active_ai_tpu.")) or
             m == "multimodal_active_ai_tpu")
assert len(names) >= 20, names
print(len(names), bad)
sys.exit(1 if bad else 0)
"""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
