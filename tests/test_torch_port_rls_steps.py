"""The PyTorch port's RLS train step and eval steps against the JAX package.

One RLS train step at an epoch where the policy picks some saccades (the
rollout, the DETR update under an active clip, the per-sample reward), then
the random-control and greedy-policy eval steps on one set of draws. Inputs,
sizes and helpers are those of ``tests/test_torch_port_rls.py``: numpy-seeded
weights carried from JAX variables, JAX draws recomputed from their keys,
ResNet10 DQN and DETR backbone, canvas 64, B = 4, F = 4, A = 10, DETR
hidden 32 with 1 + 1 layers, float32, dropout 0.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import detr as jdetr
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.train import detr_train as jdetr_train
from multimodal_active_ai_tpu.train import rls_train as jrls
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import detr_train, rls_train
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from test_torch_port_rls import (A, CLASSES, CLIP, EPS, GEOM, LR, LR_BACKBONE, LR_DROP,
                                 POLICY_EPOCH, SMALL, STEPS_PER_EPOCH, WD, F, draws_of,
                                 images_of, jax_dqn, key_where, mixed, numpy_params,
                                 numpy_stats, port_dqn, t)


@pytest.fixture(scope="module")
def dqn_vars():
    return jax_dqn()


def port_detr(params, stats):
    with torch.device("meta"):
        model = DETR("ResNet10", CLASSES, **SMALL)
    model.load_state_dict(tckpt.from_jax_detr_variables(params, stats), strict=True,
                          assign=True)
    return model


@pytest.fixture(scope="module")
def detr_vars():
    model, crit = jdetr.build(SimpleNamespace(dataset="synthetic", backbone="ResNet10",
                                              pre_norm=False, position_embedding="sine",
                                              backbone_norm="frozen", **SMALL),
                              num_classes=CLASSES)
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.ones((2, F, 30, 30, 12)),
                       jnp.full((2, F, 2), 0.5))
    rng = np.random.default_rng(1)
    return (model, crit, numpy_params(v["params"], rng),
            numpy_stats(v["batch_stats"], rng, frozen=True))


@pytest.fixture(scope="module")
def jax_steps(dqn_vars, detr_vars):
    """One JAX RLS train step at POLICY_EPOCH and both eval steps (same
    key), from the numpy-seeded DETR and DQN."""
    dmodel, dparams, dstats = dqn_vars
    model, crit, params, stats = detr_vars
    rcfg = jr.RetinaConfig(**GEOM)
    tx = jdetr_train.make_detr_optimizer(params, LR, LR_BACKBONE, WD, CLIP, LR_DROP,
                                         STEPS_PER_EPOCH, pretrained_backbone=True)
    state = JaxState.create(apply_fn=model.apply, params=params, tx=tx, batch_stats=stats)
    dqn = {"params": dparams, "batch_stats": dstats}
    images, labels = images_of(3), np.array([3, 7, 0, 7])
    key = key_where(lambda d: mixed(d), 300)
    step = jrls.make_rls_train_step(model, crit, dmodel, None, rcfg, F, A, **EPS)
    new, m, ro, reward = step(state, dqn, jnp.asarray(images), jnp.asarray(labels), key,
                              jnp.asarray(POLICY_EPOCH, jnp.int32))
    k_roll = jax.random.split(key)[0]
    eval_key = key_where(lambda d: True, 400)
    evals = {greedy: jax.device_get(jrls.make_policy_eval_step(
        model, crit, dmodel, None, rcfg, F, A, greedy=greedy)(
            new, dqn, jnp.asarray(images), jnp.asarray(labels), eval_key))
        for greedy in (False, True)}
    return dict(images=images, labels=labels, draws=draws_of(k_roll),
                metrics=jax.device_get(m), rollout=jax.device_get(ro),
                reward=np.asarray(reward), params=jax.device_get(new.params),
                evals=evals, eval_draws=draws_of(eval_key))


@pytest.fixture(scope="module")
def port_steps(dqn_vars, detr_vars, jax_steps):
    """The port's RLS train step and both eval steps on JAX's draws."""
    _, dparams, dstats = dqn_vars
    _, _, params, stats = detr_vars
    model = port_detr(params, stats)
    state = TrainState(model, detr_train.make_detr_optimizer(model, LR, LR_BACKBONE, WD),
                       detr_train.step_lr(STEPS_PER_EPOCH, LR_DROP))
    dqn = port_dqn(dparams, dstats)
    crit = SetCriterion(SMALL["num_queries"], CLASSES)
    cfg = tr.RetinaConfig(**GEOM)
    images, labels = t(jax_steps["images"]), t(jax_steps["labels"])
    step = rls_train.make_rls_train_step(crit, cfg, F, A, **EPS, clip_max_norm=CLIP)
    m, ro, reward = step(state, dqn, images, labels, POLICY_EPOCH, jax_steps["draws"])
    evals = {greedy: rls_train.make_policy_eval_step(crit, cfg, F, A, greedy=greedy)(
        state, dqn, images, labels, jax_steps["eval_draws"]) for greedy in (False, True)}
    return dict(state=state, metrics=m, rollout=ro, reward=reward, evals=evals)


def test_rls_train_step_matches_jax(detr_vars, jax_steps, port_steps):
    """``loss_ce`` (normwise 1e-4: float32 and the rare bf16 rounding step
    of a glimpse element), the per-sample reward of that step's train-mode
    forward before the update (exactly), the rollout's saccades (exactly),
    and the DETR parameters after one AdamW update under an active clip: a
    weight whose gradient is near zero may step differently under Adam, so
    every weight agrees to 2·lr and the median to 1% of lr_backbone, as in
    tests/test_torch_port_detr.py."""
    m = port_steps["metrics"]
    np.testing.assert_allclose(float(m["loss_ce"]), float(jax_steps["metrics"]["loss_ce"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(port_steps["reward"].numpy(), jax_steps["reward"])
    assert float(m["reward_mean"]) == pytest.approx(float(jax_steps["metrics"]["reward_mean"]))
    np.testing.assert_array_equal(port_steps["rollout"].saccades.numpy(),
                                  jax_steps["rollout"].saccades)
    assert float(m["grad_norm"]) > 10 * CLIP and port_steps["state"].step == 1
    got = port_steps["state"].model.state_dict()
    want = tckpt.from_jax_detr_variables(jax_steps["params"], detr_vars[3])
    labels = detr_train.detr_param_labels(port_steps["state"].model)
    diffs = []
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        if labels.get(k) == "frozen" or k not in labels:
            assert d.max() == 0, k
            continue
        assert d.max() <= 2 * LR, (k, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-2 * LR_BACKBONE


def test_eval_steps_match_jax_with_shared_draws(jax_steps, port_steps):
    """The random control and the greedy policy, after the train step, on
    one set of draws: ``loss_ce`` to 1e-4 relative, top-1/top-5 exactly.
    Both see the same ``num_fixs`` and fixation 0."""
    for greedy in (False, True):
        got, ref = port_steps["evals"][greedy], jax_steps["evals"][greedy]
        np.testing.assert_allclose(float(got["loss_ce"]), float(ref["loss_ce"]), rtol=1e-4)
        assert float(got["top1"]) == pytest.approx(float(ref["top1"]))
        assert float(got["top5"]) == pytest.approx(float(ref["top5"]))
    assert not port_steps["state"].model.training
