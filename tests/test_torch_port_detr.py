"""The PyTorch port's DETR glimpse-sequence classifier against the JAX package.

Same inputs on both sides: numpy-seeded images and weights carried from the
JAX variables by ``from_jax_detr_variables``; the random draws of a JAX step
(``num_fixs`` and the saccades) are recomputed from its key and handed to
the port. Small sizes: ResNet10 backbone, canvas 64, B=4, F=3, hidden 32,
2 heads, FFN 64, 2 encoder and 2 decoder layers, float32, dropout 0. The
JAX train step is the JAX package's own pieces (``collect_glimpse_sequence``,
``DETR.apply``, ``SetCriterion``, ``make_detr_optimizer``'s transformation)
with its gradients exposed, so that their global norm can be compared too.
Then the norms, position embeddings, transformer, criterion and the driver
chain SimCLR → DETR on the CPU.
"""

import dataclasses
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_active_ai_tpu import config as jconfig
from multimodal_active_ai_tpu.models import detr as jdetr
from multimodal_active_ai_tpu.models import norm as jnorm
from multimodal_active_ai_tpu.models import position_encoding as jpos
from multimodal_active_ai_tpu.models import transformer as jtrans
from multimodal_active_ai_tpu.objectives.set_criterion import SetCriterion as JaxCriterion
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import detr_train as jtrain
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu.utils import checkpoint as jckpt
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification as driver
from multimodal_active_ai_tpu_torch.models import norm as tnorm
from multimodal_active_ai_tpu_torch.models import position_encoding as tpos
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.transformer import build_transformer
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import detr_train
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, CLASSES, STEPS = 4, 3, 10, 3
SMALL = dict(num_queries=5, hidden_dim=32, nheads=2, enc_layers=2, dec_layers=2,
             dim_feedforward=64, dropout=0.0)
# lr_drop 1 epoch of 2 steps: the third update runs at 0.1x (StepLR)
LR, LR_BACKBONE, WD, CLIP, LR_DROP, STEPS_PER_EPOCH = 1e-3, 1e-4, 1e-4, 0.1, 1, 2
# Glimpses: the labeled plan has no rotation, but a sampling coordinate 1
# ulp apart can move a bf16 y weight across a rounding step (up to ~1 in a
# 0..255 pixel, in well under 1% of the elements; tests/test_torch_port_retina.py)
VIEW_ATOL, VIEW_TOL = 2.0, dict(rtol=1e-4, atol=2e-2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jax_cfg(**kw):
    return SimpleNamespace(dataset="synthetic", backbone="ResNet10", pre_norm=False,
                           position_embedding="sine", backbone_norm="frozen",
                           **{**SMALL, **kw})


def _numpy_params(tree, rng, path=()):
    """Seeded numpy values in the shapes of a flax ``params`` tree (from
    ``jax.eval_shape(model.init, ...)``, which compiles nothing): kernels
    scaled by their fan-in (convs ×√2 for the ReLUs), small biases, LayerNorm
    scales near 1, unit-normal queries, U[0, 1) embeddings."""
    if isinstance(tree, dict):
        return {k: _numpy_params(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        fan_in = (np.prod(shape[:-1]) if len(shape) != 3
                  else shape[0] * shape[1] if path[-2] == "out" else shape[0])
        gain = 2.0 if len(shape) == 4 else 1.0
        value = rng.normal(0, np.sqrt(gain / fan_in), shape)
    elif name == "scale":
        value = 1 + rng.normal(0, 0.05, shape)
    elif name == "embedding":
        value = rng.uniform(0, 1, shape)
    elif name == "query_embed":
        value = rng.normal(0, 1, shape)
    else:
        value = rng.normal(0, 0.02, shape)
    return value.astype(np.float32)


def _random_frozen_stats(tree, rng):
    """FrozenBatchNorm buffers drawn around the identity (weight ~U[0.5, 1.5],
    bias ~N(0, 0.1), mean ~N(0, 0.1), var ~U[0.5, 2])."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and {"weight", "bias", "mean", "var"} <= set(v):
            n = v["mean"].shape
            out[k] = {"weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
                      "bias": rng.normal(0, 0.1, n).astype(np.float32),
                      "mean": rng.normal(0, 0.1, n).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        else:
            out[k] = _random_frozen_stats(v, rng)
    return out


def _draws(key):
    """``num_fixs`` and the saccades ``(B, F, 2)`` that JAX's
    ``collect_glimpse_sequence`` draws from ``key``."""
    k_n, k_s = jax.random.split(key)
    num_fixs = int(jax.random.randint(k_n, (), 1, F + 1))
    sacc = jnp.stack([jax.random.uniform(k, (B, 2)) for k in jax.random.split(k_s, F)], 1)
    return num_fixs, _t(sacc)


def _step_keys():
    """Keys of the three steps; the first has padding (num_fixs < F)."""
    keys, seed = [], 10
    while len(keys) < STEPS + 1:
        k_collect = jax.random.split(jax.random.PRNGKey(seed))[0]
        if keys or _draws(k_collect)[0] < F:
            keys.append(jax.random.PRNGKey(seed))
        seed += 1
    return keys


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX DETR train steps (pretrained backbone, active clip) and an
    eval step, from a numpy-seeded model state."""
    model, crit = jdetr.build(_jax_cfg(), num_classes=CLASSES)
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.ones((2, F, 30, 30, 12)),
                       jnp.full((2, F, 2), 0.5))
    rng = np.random.default_rng(0)
    params = _numpy_params(v["params"], rng)
    stats = _random_frozen_stats(v["batch_stats"], rng)
    images = np.random.default_rng(1).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    labels = np.array([3, 7, 0, 7])
    rcfg = jr.RetinaConfig(**GEOM)
    tx = jtrain.make_detr_optimizer(params, LR, LR_BACKBONE, WD, CLIP, LR_DROP,
                                    STEPS_PER_EPOCH, pretrained_backbone=True)

    @jax.jit
    def grads(p, images, labels, key):
        glimpses, sacc, mask = jtrain.collect_glimpse_sequence(images, key, rcfg, F)

        def loss_fn(p):
            out = model.apply({"params": p, "batch_stats": stats}, glimpses, sacc, mask,
                              train=True)
            return crit(out["pred_logits"], labels)["loss_ce"], out

        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return g, loss, out, optax.global_norm(g), (glimpses, sacc, mask)

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    keys = _step_keys()
    p, opt_state = params, tx.init(params)
    losses, norms, outs, draws, collected = [], [], [], [], []
    for key in keys[:STEPS]:
        k_collect = jax.random.split(key)[0]
        g, loss, out, gnorm, seq = grads(p, jnp.asarray(images), jnp.asarray(labels), k_collect)
        p, opt_state = update(g, opt_state, p)
        losses.append(float(loss))
        norms.append(float(gnorm))
        outs.append(jax.device_get(out))
        draws.append(_draws(k_collect))
        collected.append(jax.device_get(seq))
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    state = JaxState.create(apply_fn=model.apply, params=p, tx=optax.identity(),
                            batch_stats=stats)
    ev = jtrain.make_detr_eval_step(model, crit, mesh, rcfg, F)(
        state, jnp.asarray(images), jnp.asarray(labels), keys[STEPS])
    return dict(params0=params, stats=stats, params=jax.device_get(p), images=images,
                labels=labels, losses=losses, norms=norms, outs=outs, draws=draws,
                first=collected[0], eval=jax.device_get(ev), eval_draws=_draws(keys[STEPS]))


def _port_model(params, stats, **kw):
    model = DETR("ResNet10", CLASSES, **{**SMALL, **kw})
    model.load_state_dict(tckpt.from_jax_detr_variables(params, stats))
    return model


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The same three steps and eval step in the port."""
    model = _port_model(jax_run["params0"], jax_run["stats"])
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, detr_train.make_detr_optimizer(model, LR, LR_BACKBONE, WD),
                       detr_train.step_lr(STEPS_PER_EPOCH, LR_DROP))
    crit = SetCriterion(SMALL["num_queries"], CLASSES)
    cfg = tr.RetinaConfig(**GEOM)
    step = detr_train.make_detr_train_step(crit, cfg, F, CLIP)
    images, labels = _t(jax_run["images"]), _t(jax_run["labels"])
    ms = [step(state, images, labels, num_fixs=n, saccades=s) for n, s in jax_run["draws"]]
    n, s = jax_run["eval_draws"]
    ev = detr_train.make_detr_eval_step(crit, cfg, F)(state, images, labels, num_fixs=n,
                                                     saccades=s)
    return dict(state=state, metrics=ms, initial=initial, eval=ev)


# ---------------------------------------------------------------------------
# config, glimpse collection, forward, criterion


def test_detr_config_matches_jax():
    """The DETR driver's flags are the JAX driver's (the reference's
    underscore flags included), names and defaults, plus ``--device``."""
    def flags(cls):
        return {f.name: (f.metadata.get("names"), f.default, f.metadata.get("choices"),
                         f.metadata.get("action")) for f in dataclasses.fields(cls)}

    port = flags(tconfig.DETRConfig)
    assert port.pop("device")[1] == "cuda"
    assert port == flags(jconfig.DETRConfig)
    cfg = tconfig.parse_into(tconfig.DETRConfig, [
        "ck.pth.tar", "data", "--enc_layers", "3", "--lr_backbone", "2e-5",
        "--clip_max_norm", "0.5", "--pre_norm", "--position_embedding", "learned"])
    assert (cfg.backbone_path, cfg.data, cfg.enc_layers, cfg.lr_backbone, cfg.clip_max_norm,
            cfg.pre_norm, cfg.position_embedding, cfg.dec_layers) == (
        "ck.pth.tar", "data", 3, 2e-5, 0.5, True, "learned", 6)


def test_collect_glimpse_sequence_matches_jax(jax_run):
    """Given JAX's draws, the port collects the same glimpses, keeps the
    saccades (x, y), feeds the retina (y, x), and masks positions ≥ num_fixs."""
    glimpses_j, sacc_j, mask_j = jax_run["first"]
    n, sacc = jax_run["draws"][0]
    images = _t(jax_run["images"])
    cfg = tr.RetinaConfig(**GEOM)
    tgs.glimpse_sample.launches = 0
    glimpses, s, mask = detr_train.collect_glimpse_sequence(images, cfg, F, num_fixs=n,
                                                            saccades=sacc)
    assert tgs.glimpse_sample.launches == 0          # CPU tensors: plain version
    assert glimpses.shape == (B, F, 30, 30, 12) and n < F
    np.testing.assert_array_equal(s.numpy(), sacc_j)
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    assert mask[:, n:].all() and not mask[:, :n].any()
    got = glimpses.numpy()
    np.testing.assert_allclose(got, glimpses_j, rtol=0, atol=VIEW_ATOL)
    assert (~np.isclose(got, glimpses_j, **VIEW_TOL)).mean() <= 1e-2
    # the (x, y) → (y, x) swap: position 1 is the retina at fixation (y, x)
    one = tr.apply_retina(images, tr.sample_labeled_params(None, B, 64, sacc[:, 1].flip(-1)),
                          cfg, photometric=False)
    torch.testing.assert_close(glimpses[:, 1], one, rtol=0, atol=0)
    # drawn: on the generator, deterministic, num_fixs in [1, F]
    gen = torch.Generator().manual_seed(3)
    a = detr_train.collect_glimpse_sequence(images, cfg, F, gen)
    b = detr_train.collect_glimpse_sequence(images, cfg, F, gen.manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ((a[1] >= 0) & (a[1] < 1)).all() and 1 <= int((~a[2][0]).sum()) <= F


def test_detr_forward_matches_jax(jax_run):
    """``pred_logits`` and ``aux_logits`` with a pad mask, on JAX's own
    glimpses: float32 on both sides, products summed in other orders
    through ResNet10 and four transformer layers; normwise 1e-4 (measured
    1.1e-6)."""
    glimpses, sacc, mask = (_t(x) for x in jax_run["first"])
    assert mask.any()
    model = _port_model(jax_run["params0"], jax_run["stats"]).eval()
    with torch.no_grad():
        out = model(glimpses, sacc, mask)
    ref = jax_run["outs"][0]
    assert out["pred_logits"].shape == (B, SMALL["num_queries"], CLASSES)
    assert out["aux_logits"].shape == (SMALL["dec_layers"] - 1, B, SMALL["num_queries"], CLASSES)
    assert _normwise(out["pred_logits"], ref["pred_logits"]) <= 1e-4
    assert _normwise(out["aux_logits"], ref["aux_logits"]) <= 1e-4
    with torch.no_grad():
        feats = model.features(glimpses)
    assert feats.shape == (B, F, 512 * 16)


def test_criterion_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (6, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 6)
    ref = JaxCriterion(5, 11)(jnp.asarray(logits), jnp.asarray(labels))
    got = SetCriterion(5, 11)(_t(logits), _t(labels))
    np.testing.assert_allclose(float(got["loss_ce"]), float(ref["loss_ce"]), rtol=1e-6)
    assert float(got["class_error"]) == pytest.approx(float(ref["class_error"]))


# ---------------------------------------------------------------------------
# train and eval steps


def test_detr_train_steps_match_jax(jax_run, port_run):
    """Three steps under an active clip (gradient norms ≫ 0.1). The port
    collects its own glimpses from JAX's draws. Losses and pre-clip global
    gradient norms agree to 1e-3 relative (float32, and the rare bf16
    rounding step of a glimpse element; measured 4.7e-7 and 1.2e-5). Adam
    moves each weight by about its group's lr whatever the size of its
    gradient, so a weight whose gradient is near zero may step differently:
    every weight agrees to 2·lr·steps, the median to 1% of lr_backbone
    (measured: max 0.015·lr, median 1e-5·lr_backbone). The frozen stem and
    layer1 come out bit-identical to their start."""
    ms = port_run["metrics"]
    np.testing.assert_allclose([float(m["loss_ce"]) for m in ms], jax_run["losses"], rtol=1e-3)
    norms = [float(m["grad_norm"]) for m in ms]
    np.testing.assert_allclose(norms, jax_run["norms"], rtol=1e-3)
    assert min(norms) > 10 * CLIP
    assert port_run["state"].step == STEPS
    got = port_run["state"].model.state_dict()
    want = tckpt.from_jax_detr_variables(jax_run["params"], jax_run["stats"])
    labels = detr_train.detr_param_labels(port_run["state"].model)
    diffs = []
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        if labels.get(k) == "frozen" or k not in labels:      # frozen params and buffers
            assert torch.equal(got[k], port_run["initial"][k]), k
            assert d.max() == 0, k
            continue
        assert d.max() <= 2 * LR * STEPS, (k, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-2 * LR_BACKBONE
    assert sum(lab == "frozen" for lab in labels.values()) > 0


@pytest.mark.parametrize("pretrained", [True, False])
def test_detr_param_groups_match_jax(jax_run, pretrained):
    """The parameter groups hold as many elements as the JAX labels; from
    scratch everything is 'head' and a step moves the stem too."""
    jl = jtrain.detr_param_labels(jax_run["params0"]) if pretrained else \
        jax.tree.map(lambda _: "head", jax_run["params0"])
    sizes = {}
    for lab, leaf in zip(jax.tree.leaves(jl), jax.tree.leaves(jax_run["params0"])):
        sizes[lab] = sizes.get(lab, 0) + np.size(leaf)
    model = _port_model(jax_run["params0"], jax_run["stats"])
    got = {}
    for name, p in model.named_parameters():
        lab = detr_train.detr_param_labels(model, pretrained)[name]
        got[lab] = got.get(lab, 0) + p.numel()
    assert got == sizes
    opt = detr_train.make_detr_optimizer(model, LR, LR_BACKBONE, WD, pretrained)
    assert [g["name"] for g in opt.param_groups] == (["head", "backbone"] if pretrained
                                                     else ["head"])
    if not pretrained:
        state = TrainState(model, opt, detr_train.step_lr(STEPS_PER_EPOCH, LR_DROP))
        stem = model.body.conv1.weight.detach().clone()
        step = detr_train.make_detr_train_step(SetCriterion(SMALL["num_queries"], CLASSES),
                                               tr.RetinaConfig(**GEOM), F, CLIP)
        n, s = jax_run["draws"][0]
        step(state, _t(jax_run["images"]), _t(jax_run["labels"]), num_fixs=n, saccades=s)
        assert not torch.equal(model.body.conv1.weight, stem)


def test_adamw_matches_optax():
    """``get_optimizer('adamw')`` against the JAX package's (``optax.adamw``:
    decay on every leaf, from the pre-update value) over three updates
    with a changing learning rate; float32 (rtol 1e-5)."""
    from multimodal_active_ai_tpu.train import optimizers as joptim
    from multimodal_active_ai_tpu_torch.train import optimizers as toptim

    rng = np.random.default_rng(6)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    lrs = [1e-2, 1e-2, 1e-3]
    tx = joptim.get_optimizer("adamw", lambda i: jnp.asarray(lrs)[i], weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = toptim.get_optimizer("adamw", list(tp.values()), weight_decay=0.05)
    for lr, g in zip(lrs, grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        toptim.set_learning_rate(opt, lr)
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_detr_eval_step_matches_jax(jax_run, port_run):
    """Query-mean logits → top-1/top-5, after the three steps."""
    ev, ref = port_run["eval"], jax_run["eval"]
    np.testing.assert_allclose(float(ev["loss_ce"]), float(ref["loss_ce"]), rtol=1e-3)
    assert float(ev["top1"]) == pytest.approx(float(ref["top1"]))
    assert float(ev["top5"]) == pytest.approx(float(ref["top5"]))
    assert not port_run["state"].model.training


# ---------------------------------------------------------------------------
# weight carry


def test_from_jax_detr_variables_matches_the_exporter(jax_run):
    """Key for key and value for value ``export_torch_detr_state_dict``,
    loading ``strict=True``."""
    got = tckpt.from_jax_detr_variables(jax_run["params0"], jax_run["stats"])
    want = jckpt.export_torch_detr_state_dict(jax_run["params0"], jax_run["stats"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    model = DETR("ResNet10", CLASSES, **SMALL)
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="FrozenBatchNorm"):
        tckpt.from_jax_detr_variables(jax_run["params0"], {})


# ---------------------------------------------------------------------------
# norms, position embeddings, transformer


@pytest.mark.parametrize("channels", [64, 48, 12])
def test_frozen_and_group_norms_match_jax(channels):
    """FrozenBatchNorm (buffers, x·scale + shift in the input dtype) and the
    GroupNorm adapter (groups = the largest divisor of C ≤ 32: 32, 24, 12;
    ε 1e-6), float32; both sides compute the same f32 expressions, GroupNorm
    with variances taken in other forms (normwise 1e-5)."""
    rng = np.random.default_rng(channels)
    x = rng.normal(1.0, 2.0, (3, 5, 5, channels)).astype(np.float32)
    stats = {"weight": rng.uniform(0.5, 1.5, channels), "bias": rng.normal(0, 1, channels),
             "mean": rng.normal(0, 1, channels), "var": rng.uniform(0.5, 2, channels)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    ref = jnorm.FrozenBatchNorm().apply({"batch_stats": stats}, jnp.asarray(x))
    frozen = tnorm.make_norm("frozen")(channels)
    frozen.load_state_dict({"weight": _t(stats["weight"]), "bias": _t(stats["bias"]),
                            "running_mean": _t(stats["mean"]), "running_var": _t(stats["var"])})
    assert not list(frozen.parameters())
    got = frozen(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _normwise(got, ref) <= 1e-6
    assert frozen(_t(x).permute(0, 3, 1, 2).bfloat16()).dtype == torch.bfloat16

    gn = jnorm.GroupNormAdapter()
    gv = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    gv = jax.tree.map(lambda a: rng.normal(1, 0.5, a.shape).astype(np.float32), gv)
    ref = gn.apply(gv, jnp.asarray(x))
    group = tnorm.make_norm("group")(channels)
    assert group.num_groups == {64: 32, 48: 24, 12: 12}[channels]
    group.load_state_dict({"weight": _t(gv["params"]["GroupNorm_0"]["scale"]),
                           "bias": _t(gv["params"]["GroupNorm_0"]["bias"])})
    got = group(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _normwise(got, ref) <= 1e-5


@pytest.mark.parametrize("kind", ["sine", "learned"])
def test_position_embeddings_match_jax(kind):
    """Over (x, y) saccades, normalised by the max over S (sine)."""
    sacc = np.random.default_rng(5).uniform(0, 1, (3, 4, 2)).astype(np.float32)
    jmod = jpos.build_position_encoding(kind, 32)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(sacc))
    ref = jmod.apply(v, jnp.asarray(sacc))
    tmod = tpos.build_position_encoding(kind, 32)
    if kind == "learned":
        tmod.load_state_dict({f"{n}.weight": _t(v["params"][n]["embedding"])
                              for n in ("row_embed", "col_embed")})
    got = tmod(_t(sacc))
    assert got.shape == (3, 4, 32)
    # sine: sin/cos of arguments up to 2π·1 in f32, computed in other orders
    assert _normwise(got, ref) <= (1e-5 if kind == "sine" else 0)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_transformer_matches_jax(pre_norm):
    """Post- and pre-norm, with a pad mask (rows padded from 3, 1 and 4
    of 4 positions on): ``hs`` of every decoder layer and the memory;
    float32, normwise 1e-5."""
    rng = np.random.default_rng(7)
    src = rng.normal(0, 1, (3, 4, 32)).astype(np.float32)
    pos = rng.normal(0, 1, (3, 4, 32)).astype(np.float32)
    query = rng.normal(0, 1, (5, 32)).astype(np.float32)
    mask = np.arange(4)[None] >= np.array([3, 1, 4])[:, None]
    jmod = jtrans.build_transformer(hidden_dim=32, dropout=0.0, nheads=2, dim_feedforward=64,
                                    enc_layers=2, dec_layers=2, pre_norm=pre_norm)
    args = [jnp.asarray(a) for a in (src, mask, query, pos)]
    v = {"params": _numpy_params(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(1), *args)["params"], rng)}
    hs_ref, mem_ref = jax.jit(jmod.apply)(v, *args)
    port = build_transformer(hidden_dim=32, dropout=0.0, nheads=2, dim_feedforward=64,
                             enc_layers=2, dec_layers=2, pre_norm=pre_norm)
    port.load_state_dict(tckpt.from_jax_transformer_variables(v["params"]), strict=True)
    assert (port.encoder.norm is not None) == pre_norm
    hs, mem = port(*[_t(a) for a in (src, mask, query, pos)])
    assert hs.shape == (2, 3, 5, 32)
    assert _normwise(hs, hs_ref) <= 1e-5 and _normwise(mem, mem_ref) <= 1e-5
    # a padded position's value does not reach the output
    src2 = src.copy()
    src2[1, 2:] += 100.0
    hs2, _ = port(*[_t(a) for a in (src2, mask, query, pos)])
    torch.testing.assert_close(hs2[:, 1], hs[:, 1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the driver chain on the CPU: SimCLR → DETR, resume, -e, export


SIMCLR_ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", str(B),
               "--canvas-size", "64", "-f", "2", "-t", "--num-examples", "8", "-p", "1",
               "--epochs", "1", "--device", "cpu"]
DETR_ARGS = ["--dataset", "synthetic", "--backbone", "ResNet10", "-b", str(B),
             "--canvas-size", "64", "-f", str(F), "-t", "--num-examples", "8", "-p", "1",
             "--epochs", "1", "--device", "cpu", "--num-classes", str(CLASSES),
             "--enc_layers", "2", "--dec_layers", "2", "--hidden_dim", "32", "--nheads", "2",
             "--dim_feedforward", "64", "--num_queries", str(SMALL["num_queries"])]


@pytest.fixture(scope="module")
def simclr_checkpoint(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("simclr"))
    simclr_driver.main(SIMCLR_ARGS + ["--checkpoint-dir", ck])
    return os.path.join(ck, "checkpoint.pth.tar")


def test_driver_chain_trains_resumes_and_exports_on_cpu(simclr_checkpoint, jax_run, tmp_path,
                                                        capsys):
    """The DETR driver from the port's SimCLR checkpoint: FrozenBatchNorm
    buffers from its BatchNorm statistics, finite losses, checkpoint,
    resume restoring every tensor, and the export read back by the JAX
    package's own importer into the same weights."""
    ck, export = str(tmp_path), os.path.join(tmp_path, "detr_ref.pth.tar")
    tgs.glimpse_sample.launches = 0
    state = driver.main([simclr_checkpoint] + DETR_ARGS + ["--checkpoint-dir", ck,
                                                           "--export-torch", export])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"Loss (\S+) ", out)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "=> loaded pretrained backbone" in out and "##Top-5" in out
    assert tgs.glimpse_sample.launches == 0
    simclr = tckpt.load_checkpoint(simclr_checkpoint)["state_dict"]
    body = state.model.body.state_dict()
    for k in ("bn1.running_var", "layer1.0.bn1.weight"):
        assert torch.equal(body[k], simclr["f." + k]), k     # frozen: unchanged
    payload = tckpt.load_checkpoint(os.path.join(ck, "detr_classifier_checkpoint.pth.tar"))
    assert sorted(payload) == ["best_prec1", "epoch", "optimizer", "state_dict"]
    assert payload["epoch"] == 1 and state.step == 2
    assert all(torch.isfinite(v).all() for v in payload["state_dict"].values())

    resumed = driver.main([simclr_checkpoint] + DETR_ARGS + [
        "--checkpoint-dir", ck, "--resume", os.path.join(ck, "detr_classifier_checkpoint.pth.tar")])
    assert "=> resumed from" in capsys.readouterr().out and resumed.step == 2
    now = resumed.model.state_dict()
    assert all(torch.equal(now[k], v) for k, v in payload["state_dict"].items())
    opt_now = resumed.optimizer.state_dict()["state"]
    for i, st in payload["optimizer"]["state"].items():
        assert all(torch.equal(opt_now[i][k], v) for k, v in st.items())

    p, s, exported = jckpt.import_torch_detr_checkpoint(
        export, jax_run["params0"], jax_run["stats"], nheads=SMALL["nheads"])
    back = tckpt.from_jax_detr_variables(p, s)
    assert sorted(back) == sorted(now)
    assert all(torch.equal(back[k], now[k]) for k in back)
    assert exported["epoch"] == 1


def test_driver_evaluate_only_and_group_norm_guard(simclr_checkpoint, tmp_path, capsys):
    prec1, prec5 = driver.main([simclr_checkpoint] + DETR_ARGS + ["-e", "--checkpoint-dir",
                                                                  str(tmp_path)])
    out = capsys.readouterr().out
    assert "##Top-1" in out and 0 <= prec1 <= prec5 <= 100
    with pytest.raises(ValueError, match="group"):
        driver.main([simclr_checkpoint] + DETR_ARGS + ["--backbone-norm", "group"])


@pytest.mark.parametrize("flag", [["--canvas-cache", "c"], ["--dataset", "imagenet"],
                                  ["--multislice"]])
def test_driver_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        driver.main(["x"] + DETR_ARGS + flag)


def test_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    args = list(DETR_ARGS)
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["x"] + args)
