"""The retina's ``fused`` and ``canvas`` modes in the port, against the JAX
package's.

Same inputs on both sides: numpy-seeded images, the JAX-sampled
``AugParams`` handed across as tensors, and the noise JAX draws (``fused``:
one ``(g, g, 3)`` draw a level from ``fold_in(key_i, level)``; ``canvas``:
one ``(c, c, 3)`` draw an image). At canvas 64: the three ``image_ops``
samplers, both modes with the photometric stages on and off,
``foveated_pyramid``'s crops and resizes. At canvas 640: the ``canvas``
mode against ``tests/data/dali_golden.npz`` under
``tests/test_dali_golden.py``'s own bounds. Then one trainer step per
non-``matmul`` branch (SimCLR, the probe, DETR, the RLS rollout) with
``mode='fused'`` against the JAX step on the same weights and draws.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import LogisticRegression as JaxProbe
from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.models import detr as jdetr
from multimodal_active_ai_tpu.models.qnet import build_dqn as jbuild_dqn
from multimodal_active_ai_tpu.ops import image_ops as jio
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import detr_train as jdetr_train
from multimodal_active_ai_tpu.train import eval_probe as jprobe
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train import rls_train as jrls
from multimodal_active_ai_tpu.train import schedule as jsched
from multimodal_active_ai_tpu.train import simclr_train as jtrain
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import image_ops as tio
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import detr_train, eval_probe, optimizers, rls_train
from multimodal_active_ai_tpu_torch.train import schedule as tsched
from multimodal_active_ai_tpu_torch.train import simclr_train as ttrain
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, G = 4, 30
# every photometric stage on: grid mask, noise and colour twist
PHOTO = dict(grid_mask_prob=1.0, gaussian_noise_prob=1.0, color_aug_prob=1.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "dali_golden.npz")
# Samplers: the same f32 arithmetic; the separable resize sums its products
# in another order than XLA's einsum (a few ulps of 255, 1.5e-5 each).
OPS_ATOL = 5e-4
# Whole views: the coordinate chain runs through f32 sin/cos, which XLA and
# torch may round 1 ulp apart (~1e-5 px, ~3e-3 in a 0..255 pixel), and the
# colour twist scales values by up to ~2 (measured: 1.1e-3).
VIEW_TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread here. In a process where XLA has run, torch's
    multithreaded CPU kernels now and then give one thread's share of an
    elementwise op another result (measured: in 1 of 4 processes, an
    eighth of a tensor's Adam update 3e-4 relative off); on one thread the
    port's results are the same every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, n=B, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _init(model, *args, seed=0, **kw):
    """``model.init``'s tree (shapes from ``eval_shape``, which compiles
    nothing) with seeded values: kernels by fan-in, scales and variances
    near 1, the rest small."""
    rng = np.random.default_rng(seed)

    def value(path, x):
        name, shape = path[-1].key, x.shape
        if name in ("scale", "var", "weight"):
            return (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
        std = np.sqrt(2.0 / np.prod(shape[:-1])) if name == "kernel" and len(shape) in (2, 4) \
            else 0.05
        return (std * rng.standard_normal(shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(value, shapes)


def _port_params(p):
    return tr.AugParams(*[_t(x) for x in p])


def _jax_noise(cfg, key, batch):
    """The standard-normal draws JAX's ``fused``/``canvas`` retina adds for
    ``key``, in the port's :func:`~retina.noise_shape`."""
    keys = jax.random.split(key, batch)
    if cfg.mode == "canvas":
        c = cfg.canvas_size
        return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (c, c, 3)))(keys))
    levels = range(len(cfg.crop_sizes))
    g = cfg.glimpse_size
    return np.asarray(jax.vmap(lambda k: jnp.concatenate(
        [jax.random.normal(jax.random.fold_in(k, li), (g, g, 3)) for li in levels], -1))(keys))


_j_retina = jax.jit(jr.apply_retina, static_argnames=("cfg", "photometric"))


# ---------------------------------------------------------------------------
# image_ops


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (B, 64, 64, 3)).astype(np.float32)
    coords = rng.uniform(-3, 67, (B, 10, 7, 2)).astype(np.float32)   # some off the edges
    mask = rng.uniform(size=(B, 10, 7)) < 0.3
    ref = jax.jit(jax.vmap(lambda x, c, m: jio.bilinear_sample(x, c, 0.0, m)))(img, coords, mask)
    got = tio.bilinear_sample(_t(img), _t(coords), 0.0, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=OPS_ATOL)
    assert (got.numpy()[mask] == 0).all()
    unfilled = tio.bilinear_sample(_t(img), _t(coords))
    np.testing.assert_allclose(unfilled.numpy(), np.asarray(
        jax.jit(jax.vmap(jio.bilinear_sample))(img, coords)), rtol=0, atol=OPS_ATOL)


@pytest.mark.parametrize("out_hw", [(30, 30), (17, 90), (64, 64)])
def test_resize_with_filter_matches_jax(out_hw):
    img = np.random.default_rng(1).uniform(0, 255, (2, 64, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda x: jio.resize_with_filter(x, out_hw)))(img))
    got = tio.resize_with_filter(_t(img), out_hw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OPS_ATOL)


@pytest.mark.parametrize("crop", [40, 24, 10, 30])
def test_crop_resize_with_filter_matches_jax(crop):
    """The canvas-64 pyramid's crops at fractional origins, to 30×30 (a
    downscale, an upscale and the identity scale)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (B, 64, 64, 3)).astype(np.float32)
    origin = (rng.uniform(0, 1, (B, 2)) * (64 - crop)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda x, o: jio.crop_resize_with_filter(
        x, o, (crop, crop), (G, G))))(img, origin))
    got = tio.crop_resize_with_filter(_t(img), _t(origin), (crop, crop), (G, G))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OPS_ATOL)


# ---------------------------------------------------------------------------
# the two modes and the visualisation pipeline


@pytest.mark.parametrize("photometric", [False, True])
@pytest.mark.parametrize("mode", ["fused", "canvas"])
def test_retina_mode_matches_jax(mode, photometric):
    jcfg = jr.RetinaConfig(**GEOM, mode=mode, **PHOTO)
    tcfg = tr.RetinaConfig(**GEOM, mode=mode, **PHOTO)
    images = _images(3)
    p = jr.sample_unlabeled_params(jax.random.PRNGKey(4), B, 64, jcfg)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(_j_retina(jnp.asarray(images), p, key, cfg=jcfg, photometric=photometric))
    noise = _t(_jax_noise(jcfg, key, B))
    assert tuple(noise.shape) == tr.noise_shape(tcfg, B)
    tgs.glimpse_sample.launches = 0
    got = tr.apply_retina(_t(images), _port_params(p), tcfg, photometric, noise=noise)
    assert got.shape == (B, G, G, 12) and got.dtype == torch.float32
    assert tgs.glimpse_sample.launches == 0
    np.testing.assert_allclose(got.numpy(), ref, **VIEW_TOL)
    if photometric:   # the generator draws the same shapes; its views differ by seed
        gen = lambda s: torch.Generator().manual_seed(s)   # noqa: E731
        a, b = (tr.apply_retina(_t(images), _port_params(p), tcfg, True, generator=gen(s))
                for s in (0, 1))
        assert torch.isfinite(a).all() and not torch.equal(a, b)


@pytest.mark.parametrize("fix", [(0.3, 0.71), (0.999, 0.0)])
def test_foveated_pyramid_matches_jax(fix):
    """A 50-px source (resized to the 64 canvas first), rotated 13.5°: the
    five crops (the canvas and each level; the second fixation rounds an
    origin to the canvas edge, which ``dynamic_slice`` clamps) and their
    30×30 resizes."""
    img = _images(6, 1, 50)[0]
    jcfg, tcfg = jr.RetinaConfig(**GEOM), tr.RetinaConfig(**GEOM)
    jc, jrs = jax.jit(jr.foveated_pyramid, static_argnums=3)(
        jnp.asarray(img), jnp.asarray(fix, jnp.float32), jnp.asarray(13.5), jcfg)
    tc, trs = tr.foveated_pyramid(_t(img), torch.tensor(fix), torch.tensor(13.5), tcfg)
    assert [tuple(c.shape) for c in tc] == [(s, s, 3) for s in (64, 40, 24, 10, 30)]
    for got, ref in zip(tc + trs, jc + jrs):   # rotated coordinates: the view tolerance
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VIEW_TOL)


# the parameter sets of tests/test_dali_golden.py (tools/make_dali_golden.py)
GOLDEN_CASES = {
    "labeled": dict(fix_yx=(0.3, 0.7), angle=13.5),
    "unlabeled_geo": dict(fix_yx=(0.6, 0.2), angle=-20.0, rrc_origin_yx=(50, 80),
                          rrc_size_hw=(500, 430), flip=True),
}


def golden_params(kw) -> tr.AugParams:
    """``tests/test_dali_golden.py``'s parameter set as the port's."""
    p = tr.neutral_params(1, 640)._replace(fix_yx=torch.tensor([kw["fix_yx"]]),
                                           angle=torch.tensor([kw["angle"]]))
    if "rrc_origin_yx" in kw:
        p = p._replace(rrc_origin_yx=torch.tensor([kw["rrc_origin_yx"]], dtype=torch.float32),
                       rrc_size_hw=torch.tensor([kw["rrc_size_hw"]], dtype=torch.float32),
                       flip=torch.tensor([kw["flip"]]))
    return p


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_canvas_mode_meets_the_dali_golden_fixture(name):
    """The bounds of ``tests/test_dali_golden.py``: mean |d| < 1.5 and
    p99 < 7 on the 0..255 scale (the JAX canvas mode: mean 0.56/0.62,
    p99 2.6/3.3)."""
    data = np.load(GOLDEN)
    cfg = tr.RetinaConfig(canvas_size=640, crop_sizes=(400, 240, 100, 30), mode="canvas")
    got = tr.apply_retina(_t(data["source"][None]), golden_params(GOLDEN_CASES[name]), cfg,
                          False)[0].numpy()
    d = np.abs(got - data[f"expected_{name}"])
    assert d.mean() < 1.5, f"{name}: mean|d| {d.mean():.3f}"
    assert np.percentile(d, 99) < 7.0, f"{name}: p99 {np.percentile(d, 99):.2f}"


# ---------------------------------------------------------------------------
# the trainers' fused branches


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(data=1, model=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def encoder_vars():
    return _init(JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn"),
                 jnp.ones((2, G, G, 12)), train=False)


def _port_encoder(variables):
    with torch.device("meta"):
        model = SimCLRModule(arch="ResNet10")
    model = model.to_empty(device="cpu")
    model.load_state_dict(tckpt.from_jax_variables(variables["params"],
                                                   variables["batch_stats"]))
    return model


def test_simclr_fused_step_matches_jax(encoder_vars, mesh):
    """One fixation (two views): the losses to 2e-3 relative, as the
    ``matmul`` step's test (NT-Xent at T=0.05 amplifies f32 projection
    differences ~20x), and every weight after the Adam update to ``2·lr``
    with the median weight to 1% of ``lr`` (Adam's first step moves a
    weight by ~lr whatever its gradient's size)."""
    lr_args, temp = (0.01, B, 16, B, 0, 5), 0.05
    model = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    tx = joptim.get_optimizer("adam", jsched.simclr_learning_rate(*lr_args))
    state = JaxState.create(apply_fn=model.apply, params=encoder_vars["params"], tx=tx,
                            batch_stats=encoder_vars["batch_stats"])
    jcfg = jr.RetinaConfig(**GEOM, mode="fused", **PHOTO)
    images, key = _images(7), jax.random.PRNGKey(8)
    state1, metrics = jtrain.make_train_step(model, mesh, jcfg, 1, temp, donate=False)(
        state, jnp.asarray(images), key)

    tcfg = tr.RetinaConfig(**GEOM, mode="fused", **PHOTO)
    params, noise = [], []
    for kp, kn in jax.random.split(key, 4).reshape(2, 2, 2):
        params.append(_port_params(jr.sample_unlabeled_params(kp, B, 64, jcfg)))
        noise.append(_t(_jax_noise(jcfg, kn, B)))
    port = _port_encoder(encoder_vars)
    tstate = ttrain.TrainState(port, optimizers.get_optimizer("adam", port.parameters()),
                               tsched.simclr_learning_rate(*lr_args))
    tgs.glimpse_sample.launches = 0
    losses = ttrain.make_train_step(tcfg, 1, temp)(tstate, _t(images), params=params,
                                                   noise=noise)
    assert tgs.glimpse_sample.launches == 0 and tstate.step == tstate.count == 1
    np.testing.assert_allclose(losses.numpy(), np.asarray(metrics["losses"]), rtol=2e-3)
    lr = tsched.simclr_learning_rate(*lr_args)(0)
    want = tckpt.from_jax_variables(jax.device_get(state1.params), None)
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                            for n, p in port.named_parameters()])
    assert diffs.max() <= 2 * lr * (1 + 1e-3) and np.median(diffs) <= 1e-2 * lr


def test_probe_fused_step_matches_jax(encoder_vars, mesh):
    """One probe step, the fixations drawn one retina call at a time: the
    loss, and the probe's weights after Adam (float32 features of an
    eval-mode encoder; measured well under the bounds)."""
    F, classes, lr_args = 2, 10, (1e-3, B, 16, B, 0, 5)
    feat = 512 * 16 * F
    probe = JaxProbe(num_classes=classes)
    head = _init(probe, jnp.ones((2, feat)), seed=1)["params"]
    jcfg = jr.RetinaConfig(**GEOM, mode="fused")
    state = JaxState.create(apply_fn=probe.apply, params=head, batch_stats={},
                            tx=joptim.get_optimizer("adam", jsched.simclr_learning_rate(*lr_args)))
    encoder = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    images, labels, key = _images(9), np.array([1, 9, 4, 4]), jax.random.PRNGKey(10)
    state1, m = jprobe.make_probe_train_step(encoder, probe, mesh, jcfg, F)(
        state, encoder_vars, jnp.asarray(images), jnp.asarray(labels), key)

    fix = np.concatenate([np.asarray(jax.random.uniform(k, (B, 2)))
                          for k in jax.random.split(key, F)])          # view-major
    tprobe = LogisticRegression(feat, classes)
    tprobe.load_state_dict(tckpt.from_jax_probe_variables(head, F))
    tstate = ttrain.TrainState(tprobe, optimizers.get_optimizer("adam", tprobe.parameters()),
                               tsched.simclr_learning_rate(*lr_args))
    got = eval_probe.make_probe_train_step(tr.RetinaConfig(**GEOM, mode="fused"), F)(
        tstate, _port_encoder(encoder_vars), _t(images), _t(labels), fix_yx=_t(fix))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-4)
    want = tckpt.from_jax_probe_variables(jax.device_get(state1.params), F)
    for name, p in tprobe.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=2e-3 * lr_args[0] * B / 256, err_msg=name)


DETR_SMALL = dict(num_queries=5, hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
                  dim_feedforward=64, dropout=0.0)


def test_detr_fused_step_matches_jax(mesh):
    """One DETR step (pretrained groups, active clip, dropout 0) whose F
    glimpses come one ``fused`` retina call a fixation: the glimpse
    sequence to the view tolerance, the loss to 1e-4 relative."""
    F, classes = 3, 10
    jcfg = SimpleNamespace(dataset="synthetic", backbone="ResNet10", pre_norm=False,
                           position_embedding="sine", backbone_norm="frozen", **DETR_SMALL)
    model, crit = jdetr.build(jcfg, num_classes=classes)
    v = _init(model, jnp.ones((2, F, G, G, 12)), jnp.full((2, F, 2), 0.5), seed=2)
    tx = jdetr_train.make_detr_optimizer(v["params"], 1e-3, 1e-4, 1e-4, 0.1, 200, 2)
    state = JaxState.create(apply_fn=model.apply, params=v["params"], tx=tx,
                            batch_stats=v["batch_stats"])
    rcfg = jr.RetinaConfig(**GEOM, mode="fused")
    images, labels, key = _images(11), np.array([3, 7, 0, 7]), jax.random.PRNGKey(12)
    step = jdetr_train.make_detr_train_step(model, crit, mesh, rcfg, F)
    _, m = step(state, jnp.asarray(images), jnp.asarray(labels), key)
    k_n, k_s = jax.random.split(jax.random.split(key)[0])
    num_fixs = int(jax.random.randint(k_n, (), 1, F + 1))
    sacc = np.stack([np.asarray(jax.random.uniform(k, (B, 2)))
                     for k in jax.random.split(k_s, F)], 1)
    glimpses, _, _ = jdetr_train.collect_glimpse_sequence(jnp.asarray(images), jax.random.split(
        key)[0], rcfg, F)

    tmodel = DETR("ResNet10", classes, **DETR_SMALL)
    tmodel.load_state_dict(tckpt.from_jax_detr_variables(v["params"], v["batch_stats"]))
    tstate = ttrain.TrainState(tmodel, detr_train.make_detr_optimizer(tmodel, 1e-3, 1e-4, 1e-4),
                               detr_train.step_lr(2, 200))
    tcfg = tr.RetinaConfig(**GEOM, mode="fused")
    got, _, _ = detr_train.collect_glimpse_sequence(_t(images), tcfg, F, saccades=_t(sacc),
                                                    num_fixs=num_fixs)
    np.testing.assert_allclose(got.numpy(), np.asarray(glimpses), **VIEW_TOL)
    out = detr_train.make_detr_train_step(SetCriterion(DETR_SMALL["num_queries"], classes), tcfg,
                                          F, 0.1)(tstate, _t(images), _t(labels),
                                                  num_fixs=num_fixs, saccades=_t(sacc))
    np.testing.assert_allclose(float(out["loss_ce"]), float(m["loss_ce"]), rtol=1e-4)


def test_rls_fused_rollout_matches_jax():
    """The rollout at epoch 0 (every fixation random) with the ``fused``
    retina: the saccades and mask exactly, the glimpses to the view
    tolerance."""
    F, A = 3, 10
    dqn = jbuild_dqn("ResNet10", A, norm_kind="bn", axis_name=None)
    v = _init(dqn, jnp.ones((2, G, G, 12)), train=False, seed=3)
    eps = dict(eps_start=0.9, eps_end=0.05, eps_decay=200)
    rcfg = jr.RetinaConfig(**GEOM, mode="fused")
    images, key = _images(13), jax.random.PRNGKey(14)
    ref = jax.jit(jrls.make_rollout(dqn, rcfg, F, A, **eps))(
        v, jnp.asarray(images), key, jnp.asarray(0, jnp.int32))
    k_n, k_loop = jax.random.split(key)
    coins, fixes = [], []
    for kj in jax.random.split(k_loop, F):
        k_coin, k_rand, _ = jax.random.split(kj, 3)
        coins.append(float(jax.random.uniform(k_coin, ())))
        fixes.append(np.asarray(jax.random.uniform(k_rand, (B, 2))))
    draws = rls_train.RolloutDraws(int(jax.random.randint(k_n, (), 2, max(F, 3))),
                                   tuple(coins), _t(np.stack(fixes)))
    with torch.device("meta"):
        tdqn = build_dqn("ResNet10", A)
    tdqn = tdqn.to_empty(device="cpu")
    tdqn.load_state_dict(tckpt.from_jax_dqn_variables(v["params"], v["batch_stats"]))
    ro = rls_train.make_rollout(tr.RetinaConfig(**GEOM, mode="fused"), F, A, **eps)(
        tdqn, _t(images), draws, 0)
    np.testing.assert_array_equal(ro.saccades.numpy(), np.asarray(ref.saccades))
    np.testing.assert_array_equal(ro.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ro.glimpses.numpy(), np.asarray(ref.glimpses), **VIEW_TOL)
