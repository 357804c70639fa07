"""The PyTorch port's reinforcement-learned saccades (RLS) against the JAX package.

Same inputs on both sides: numpy-seeded images and weights, carried from the
JAX variables by ``from_jax_dqn_variables`` and ``from_jax_detr_variables``;
the random draws of a JAX rollout (``num_fixs``, one ε coin and one random
fixation per fixation) are recomputed from its key and handed to the port as
a ``RolloutDraws``. Small sizes: canvas 64, ResNet10 DQN and DETR backbone,
A = 10 actions (A = 100 where the action round-trip matters), B = 4, F = 4
(so ``num_fixs ∈ {2, 3}``), DETR hidden 32 with 1 + 1 layers, 2 heads, FFN
64, float32, dropout 0. Module by module: the DQN, the Bellman loss,
RMSprop, the replay memory, ε, the rollout and the DQN update; then the driver chain SimCLR → RLS on the CPU.
The RLS train step and the eval steps, whose JAX references take the
longest to compile, are in ``tests/test_torch_port_rls_steps.py``, which
takes its helpers from here.

Glimpses are compared as the DETR tests compare them: the labeled plan has
no rotation, but a sampling coordinate 1 ulp apart can move a bf16 y weight
across a rounding step (up to ~1 in a 0..255 pixel, in well under 1% of the
elements; tests/test_torch_port_retina.py).
"""

import copy
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_active_ai_tpu import config as jconfig
from multimodal_active_ai_tpu.models.qnet import build_dqn as jbuild_dqn
from multimodal_active_ai_tpu.objectives import dqn_loss as jloss
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.rl import policy as jpolicy
from multimodal_active_ai_tpu.rl.replay_memory import ReplayMemory as JaxMemory
from multimodal_active_ai_tpu.train import rls_train as jrls
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification_rls as driver
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.objectives import dqn_loss
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.rl import policy as tpolicy
from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory
from multimodal_active_ai_tpu_torch.train import rls_train
from multimodal_active_ai_tpu_torch.train import optimizers as toptim
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, A, CLASSES = 4, 4, 10, 10
SMALL = dict(num_queries=5, hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
             dim_feedforward=64, dropout=0.0)
EPS = dict(eps_start=0.9, eps_end=0.05, eps_decay=10.0)
POLICY_EPOCH = 5                    # ε(5) = 0.566: some fixations greedy, some random
LR, LR_BACKBONE, WD, CLIP, LR_DROP, STEPS_PER_EPOCH = 1e-3, 1e-4, 1e-4, 0.1, 200, 2
DQN_LR, GAMMA = 1e-3, 0.9
VIEW_ATOL, VIEW_TOL = 2.0, dict(rtol=1e-4, atol=2e-2)


def t(x):
    return torch.from_numpy(np.array(x))


def normwise(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def numpy_params(tree, rng, path=()):
    """Seeded numpy values in the shapes of a flax ``params`` tree: kernels
    scaled by their fan-in (convs ×√2 for the ReLUs), BN/LayerNorm scales
    near 1, small biases, unit-normal queries."""
    if isinstance(tree, dict):
        return {k: numpy_params(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        fan_in = (np.prod(shape[:-1]) if len(shape) != 3
                  else shape[0] * shape[1] if path[-2] == "out" else shape[0])
        value = rng.normal(0, np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in), shape)
    elif name == "scale":
        value = 1 + rng.normal(0, 0.05, shape)
    elif name == "query_embed":
        value = rng.normal(0, 1, shape)
    else:
        value = rng.normal(0, 0.02, shape)
    return value.astype(np.float32)


def numpy_stats(tree, rng, frozen):
    """BatchNorm statistics (mean ~N(0, 0.1), var ~U[0.5, 2]); FrozenBatchNorm
    slots also get weight ~U[0.5, 1.5] and bias ~N(0, 0.1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and {"mean", "var"} <= set(v):
            n = v["mean"].shape
            out[k] = {"mean": rng.normal(0, 0.1, n), "var": rng.uniform(0.5, 2.0, n)}
            if frozen:
                out[k].update(weight=rng.uniform(0.5, 1.5, n), bias=rng.normal(0, 0.1, n))
            out[k] = {s: a.astype(np.float32) for s, a in out[k].items()}
        else:
            out[k] = numpy_stats(v, rng, frozen)
    return out


def images_of(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def draws_of(key, batch=B):
    """The draws ``make_rollout`` takes from ``key``: ``k_n``/``k_loop``, then
    ``k_coin``/``k_rand``/``k_ret`` per fixation (``k_ret`` feeds nothing on
    the labeled retina)."""
    k_n, k_loop = jax.random.split(key)
    num_fixs = int(jax.random.randint(k_n, (), 2, max(F, 3)))
    coins, fixes = [], []
    for kj in jax.random.split(k_loop, F):
        k_coin, k_rand, _ = jax.random.split(kj, 3)
        coins.append(float(jax.random.uniform(k_coin, ())))
        fixes.append(np.asarray(jax.random.uniform(k_rand, (batch, 2))))
    return rls_train.RolloutDraws(num_fixs, tuple(coins), t(np.stack(fixes)))


def key_where(want, start):
    """The first ``PRNGKey(seed ≥ start)`` whose rollout draws satisfy ``want``."""
    seed = start
    while not want(draws_of(jax.random.PRNGKey(seed))):
        seed += 1
    return jax.random.PRNGKey(seed)


def mixed(draws):
    """Fixations 1..F-1 hold both a greedy (coin > ε) and a random one."""
    thr = jpolicy.eps_threshold(POLICY_EPOCH, **EPS)
    greedy = [c > thr for c in draws.coins[1:]]
    return any(greedy) and not all(greedy)


def jax_dqn(seed=0):
    """A JAX ResNet10 DQN (``norm_kind='bn'``, A = 10) and numpy-seeded
    weights and statistics for it (shapes from ``eval_shape``, which
    compiles nothing)."""
    model = jbuild_dqn("ResNet10", A, norm_kind="bn", axis_name=None)
    v = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
                       jnp.ones((2, 30, 30, 12)))
    rng = np.random.default_rng(seed)
    return (model, numpy_params(v["params"], rng),
            numpy_stats(v["batch_stats"], rng, frozen=False))


@pytest.fixture(scope="module")
def dqn_vars():
    return jax_dqn()


def port_dqn(params, stats):
    """The port DQN carrying JAX weights (built on the meta device: its own
    initialisation would be overwritten)."""
    with torch.device("meta"):
        dqn = build_dqn("ResNet10", A)
    dqn.load_state_dict(tckpt.from_jax_dqn_variables(params, stats), strict=True, assign=True)
    return dqn


@pytest.fixture(scope="module")
def jax_rollouts(dqn_vars):
    """JAX rollouts at epoch 0 (num_fixs 3) and at POLICY_EPOCH (num_fixs 2,
    greedy and random fixations after the first)."""
    model, params, stats = dqn_vars
    roll = jax.jit(jrls.make_rollout(model, jr.RetinaConfig(**GEOM), F, A, **EPS))
    images = images_of(2)
    cases = {0: key_where(lambda d: d.num_fixs == 3, 100),
             POLICY_EPOCH: key_where(lambda d: d.num_fixs == 2 and mixed(d), 200)}
    out = {}
    for epoch, key in cases.items():
        ro = roll({"params": params, "batch_stats": stats}, jnp.asarray(images), key,
                  jnp.asarray(epoch, jnp.int32))
        out[epoch] = (jax.device_get(ro), draws_of(key))
    return images, out


# ---------------------------------------------------------------------------
# config, DQN, loss, optimizer, replay, ε


def test_rls_config_matches_jax():
    """The RLS driver's flags are the JAX driver's, names and defaults
    (the DETR driver's plus the DQN flags), plus ``--device``."""
    def flags(cls):
        return {f.name: (f.metadata.get("names"), f.default, f.metadata.get("choices"),
                         f.metadata.get("action")) for f in dataclasses.fields(cls)}

    port = flags(tconfig.RLSConfig)
    assert port.pop("device")[1] == "cuda"
    assert port == flags(jconfig.RLSConfig)
    cfg = tconfig.parse_into(tconfig.RLSConfig, ["ck.pth.tar", "-dqnb", "8", "--gamma", "0.5",
                                                 "--dense-replay", "--dqn", "ResNet10"])
    assert (cfg.dqn_batch_size, cfg.gamma, cfg.dense_replay, cfg.dqn, cfg.num_of_actions,
            cfg.target_update_freq, cfg.replay_memory_capacity) == (8, 0.5, True, "ResNet10",
                                                                    100, 3, 10000)


@pytest.mark.parametrize("train", [False, True])
def test_dqn_forward_matches_jax(dqn_vars, train):
    """Q values of both heads, float32, through ``from_jax_dqn_variables``
    (its C-major head permutation included): eval mode on the running
    statistics, train mode on the batch's, whose running update matches
    flax's (momentum 0.9, biased variance). Products summed in other orders
    through ResNet10: normwise 1e-4."""
    model, params, stats = dqn_vars
    x = np.random.default_rng(4).uniform(0, 255, (6, 30, 30, 12)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (qx, qy), mutated = model.apply(variables, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
    else:
        qx, qy = model.apply(variables, jnp.asarray(x), train=False)
    dqn = port_dqn(params, stats).train(train)
    gx, gy = dqn(t(x))
    assert gx.shape == gy.shape == (6, A) and gx.dtype == torch.float32
    assert normwise(gx, qx) <= 1e-4 and normwise(gy, qy) <= 1e-4
    if train:
        want = tckpt.from_jax_dqn_variables(params, mutated["batch_stats"])
        for k, v in dqn.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert normwise(v, want[k]) <= 1e-4, k
    # the JAX DQN's default sync_bn (global statistics) is bn on one process
    with torch.device("meta"):
        sync = build_dqn("ResNet10", A, norm_kind="sync_bn")
    sync.load_state_dict(tckpt.from_jax_dqn_variables(params, stats), assign=True)
    ref = port_dqn(params, stats).train(train)
    assert all(torch.equal(a, b) for a, b in zip(ref(t(x)), sync.train(train)(t(x))))
    assert all(torch.equal(v, sync.state_dict()[k]) for k, v in ref.state_dict().items())


def test_huber_and_bellman_loss_match_jax():
    """SmoothL1 (β = 1) on both branches, and the Bellman loss on random Q
    values with stored actions, A = 100; float32 (rtol 1e-6)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 2, 50), [-1.0, 1.0, 0.0, 0.999, -1.001]]).astype(np.float32)
    np.testing.assert_allclose(dqn_loss.huber(t(x)).numpy(), np.asarray(jloss.huber(x)),
                               rtol=1e-6)
    n = 16
    q = [rng.normal(0, 3, (n, 100)).astype(np.float32) for _ in range(4)]
    actions = (rng.integers(0, 100, (n, 2)).astype(np.float32) / np.float32(100))
    rewards = rng.integers(0, 2, n).astype(np.float32)
    ref = jloss.dqn_bellman_loss(*[jnp.asarray(a) for a in q], jnp.asarray(actions),
                                 jnp.asarray(rewards), 0.999, 100)
    got = dqn_loss.dqn_bellman_loss(*[t(a) for a in q], t(actions), t(rewards), 0.999, 100)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_action_round_trip_matches_jax_for_every_bin():
    """A greedy bin ``k`` stored as the JAX rollout stores it (``k / A`` in
    a compiled program: ``k·f32(1/A)``) and read back by the loss as
    ``int32(a·A)`` in float32: the same fraction and the same bin on both
    sides for every k < 100, including the bins that come back one lower
    (53 and 59 among them, which come back lower even under exact
    division), which the port keeps."""
    k = jnp.arange(100)
    stored = np.asarray(jax.jit(lambda k: k.astype(jnp.float32) / 100)(k))
    ref = np.asarray(jax.jit(lambda a: (a * 100).astype(jnp.int32))(stored))
    q = torch.nn.functional.one_hot(torch.arange(100), 100).float()
    got = tpolicy.greedy_action(q, q.flip(0), 100)
    np.testing.assert_array_equal(got[:, 0].numpy(), stored)
    np.testing.assert_array_equal(got[:, 1].numpy(), stored[::-1])
    bins = dqn_loss.action_indices(got, 100)
    np.testing.assert_array_equal(bins[:, 0].numpy(), ref)
    np.testing.assert_array_equal(bins[:, 1].numpy(), ref[::-1])
    lower = set(np.nonzero(ref != np.arange(100))[0].tolist())
    assert {53, 59} <= lower and (ref >= np.arange(100) - 1).all()
    exact = (np.arange(100, dtype=np.float32) / np.float32(100) * np.float32(100)).astype(np.int32)
    assert set(np.nonzero(exact != np.arange(100))[0].tolist()) == {53, 59}


def test_rmsprop_matches_optax():
    """``get_optimizer('rmsprop')`` against ``optax.rmsprop`` (decay 0.9,
    ε inside the root, ν from 0) over four updates; float32 (rtol 1e-5).
    ``torch.optim.RMSprop``'s defaults do not give this."""
    rng = np.random.default_rng(6)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1e-3 if i == 2 else 1, v.shape).astype(np.float32)
              for k, v in params.items()} for i in range(4)]
    tx = optax.rmsprop(DQN_LR)
    tx_update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = toptim.get_optimizer("rmsprop", list(tp.values()))
    toptim.set_learning_rate(opt, DQN_LR)
    default = torch.optim.RMSprop([torch.nn.Parameter(t(params["w"]))], lr=DQN_LR)
    for g in grads:
        updates, opt_state = tx_update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k])
        opt.step()
        default.param_groups[0]["params"][0].grad = t(g["w"])
        default.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert toptim.updates_taken(opt) == 4
    assert not np.allclose(default.param_groups[0]["params"][0].detach().numpy(),
                           np.asarray(jp["w"]), rtol=1e-3)


def _transitions(rng, n, shape=(3, 3, 2)):
    return (rng.normal(0, 1, (n,) + shape).astype(np.float32),
            rng.uniform(0, 1, (n, 2)).astype(np.float32),
            rng.normal(0, 1, (n,) + shape).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32))


def test_replay_memory_matches_jax_ring():
    """The same pushes and seed sample the same rows as the JAX ring, also
    after the ring wrapped and after a push longer than the ring; the
    ``state_dict`` round-trips."""
    rng = np.random.default_rng(7)
    jmem, tmem = JaxMemory(10, (3, 3, 2), seed=3), ReplayMemory(10, (3, 3, 2), seed=3)
    for n, draws in ((4, 3), (5, 4), (6, 5), (13, 6), (2, 10)):
        batch = _transitions(rng, n)
        jmem.push(*batch)
        tmem.push(*[t(a) for a in batch])
        assert len(tmem) == len(jmem) and tmem._head == jmem._head
        want, got = jmem.sample(draws), tmem.sample(draws)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)
    for key, value in jmem.state_dict().items():
        np.testing.assert_array_equal(tmem.state_dict()[key].numpy(), value)
    again = ReplayMemory(10, (3, 3, 2), seed=3)
    again.load_state_dict(tmem.state_dict())
    assert len(again) == 10 and again._head == 0
    for key, value in tmem.state_dict().items():
        assert torch.equal(again.state_dict()[key], value)
    with pytest.raises(ValueError, match="sample of 11"):
        tmem.sample(11)


def test_eps_threshold_and_actions_match_jax():
    for epoch in (0, 1, 5, 40):
        assert tpolicy.eps_threshold(epoch, **EPS) == pytest.approx(
            jpolicy.eps_threshold(epoch, **EPS), rel=1e-12)
    dqn = port_dqn(*jax_dqn(9)[1:]).train()
    x = t(np.random.default_rng(8).uniform(0, 255, (3, 30, 30, 12)).astype(np.float32))
    before = {k: v.clone() for k, v in dqn.state_dict().items()}
    act = tpolicy.select_action_from_policy(dqn, x, A)
    qx, qy = dqn.eval()(x)
    torch.testing.assert_close(act, tpolicy.greedy_action(qx, qy, A), rtol=0, atol=0)
    assert torch.equal(dqn_loss.action_indices(act, A)[:, 0], qx.argmax(1))
    assert all(torch.equal(v, before[k]) for k, v in dqn.state_dict().items())
    gen = torch.Generator().manual_seed(0)
    r = tpolicy.select_random_action(gen, 5)
    assert r.shape == (5, 2) and bool(((r >= 0) & (r < 1)).all())


# ---------------------------------------------------------------------------
# rollout, DQN update (the RLS train and eval steps: test_torch_port_rls_steps.py)


@pytest.mark.parametrize("epoch", [0, POLICY_EPOCH])
def test_rollout_matches_jax(dqn_vars, jax_rollouts, epoch):
    """Given JAX's draws, the port rolls out the same saccades (random and
    greedy, exactly), masks and glimpses, one glimpse-sampler call per
    fixation (the plain version on CPU tensors), and leaves the DQN's
    BatchNorm buffers as they were although the module was in train mode."""
    _, params, stats = dqn_vars
    images, rollouts = jax_rollouts
    ref, draws = rollouts[epoch]
    dqn = port_dqn(params, stats).train()
    before = {k: v.clone() for k, v in dqn.state_dict().items()}
    roll = rls_train.make_rollout(tr.RetinaConfig(**GEOM), F, A, **EPS)
    tgs.glimpse_sample.launches = 0
    ro = roll(dqn, t(images), draws, epoch)
    assert tgs.glimpse_sample.launches == 0
    assert ro.glimpses.shape == (B, F, 30, 30, 12)
    np.testing.assert_array_equal(ro.mask.numpy(), ref.mask)
    assert int((~ro.mask[0]).sum()) == draws.num_fixs == (3 if epoch == 0 else 2)
    np.testing.assert_array_equal(ro.saccades.numpy(), ref.saccades)
    random = [j == 0 or epoch == 0 or c <= tpolicy.eps_threshold(epoch, **EPS)
              for j, c in enumerate(draws.coins)]
    for j, is_random in enumerate(random):
        on_grid = np.allclose(ref.saccades[:, j] * A, np.round(ref.saccades[:, j] * A), atol=1e-4)
        if is_random:
            np.testing.assert_array_equal(ro.saccades[:, j].numpy(), draws.random_fix[j].numpy())
        else:
            assert on_grid, j                   # a greedy bin k/A
    assert all(random) if epoch == 0 else not all(random)
    got = ro.glimpses.numpy()
    np.testing.assert_allclose(got, ref.glimpses, rtol=0, atol=VIEW_ATOL)
    assert (~np.isclose(got, ref.glimpses, **VIEW_TOL)).mean() <= 1e-2
    assert dqn.training
    assert all(torch.equal(v, before[k]) for k, v in dqn.state_dict().items())


def test_eval_rollouts_share_draws_and_differ_after_fixation_0(dqn_vars):
    """Control (epoch-0 branch) and greedy (ε = 0) rollouts on one set of
    draws: the same mask and fixation 0, random vs greedy bins after it."""
    dqn = port_dqn(*dqn_vars[1:])
    draws = draws_of(jax.random.PRNGKey(11))
    cfg = tr.RetinaConfig(**GEOM)
    ctrl = rls_train.make_rollout(cfg, F, A, 0.0, 0.0, 1.0)(dqn, t(images_of(12)), draws, 0)
    pol = rls_train.make_rollout(cfg, F, A, 0.0, 0.0, 1.0)(dqn, t(images_of(12)), draws, 1)
    assert torch.equal(ctrl.mask, pol.mask)
    assert torch.equal(ctrl.saccades[:, 0], pol.saccades[:, 0])
    assert torch.equal(ctrl.saccades.transpose(0, 1), draws.random_fix)
    bins = pol.saccades[:, 1:] * A
    assert torch.allclose(bins, bins.round(), atol=1e-4)


@pytest.fixture(scope="module")
def dqn_updates(dqn_vars):
    """Two DQN updates on one replay batch against a target with other
    weights: in JAX, ``make_dqn_update_step``'s pieces (the JAX package's
    DQN in train mode, its target in eval mode, its Bellman loss, the clamp
    and ``optax.rmsprop``) with the clamped gradient exposed; and the
    port's ``make_dqn_update_step``."""
    model, params, stats = dqn_vars
    rng = np.random.default_rng(13)
    n = 8
    transition = (rng.uniform(0, 255, (n, 30, 30, 12)).astype(np.float32),
                  (rng.integers(0, A, (n, 2)).astype(np.float32) / np.float32(A)),
                  rng.uniform(0, 255, (n, 30, 30, 12)).astype(np.float32),
                  rng.integers(0, 2, n).astype(np.float32))
    jtr = tuple(jnp.asarray(a) for a in transition)
    t_params, t_stats = jax_dqn(9)[1:]
    jtarget = {"params": t_params, "batch_stats": t_stats}

    tx = optax.rmsprop(DQN_LR)

    @jax.jit
    def update(p, batch_stats, opt_state, target, tr):
        """``make_dqn_update_step`` from its pieces, with the clamped
        gradient exposed."""
        def loss_fn(p):
            (qx, qy), mutated = model.apply({"params": p, "batch_stats": batch_stats}, tr[0],
                                            train=True, mutable=["batch_stats"])
            tqx, tqy = model.apply(target, tr[2], train=False)
            return (jloss.dqn_bellman_loss(qx, qy, tqx, tqy, tr[1], tr[3], GAMMA, A),
                    mutated["batch_stats"])
        (loss, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        g = jax.tree.map(lambda g: jnp.clip(g, -1.0, 1.0), g)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), new_stats, opt_state, loss, g

    jparams, jbatch, opt_state = params, stats, tx.init(params)
    jlosses, jgrads, jstats = [], [], []
    for _ in range(2):
        jparams, jbatch, opt_state, loss, g = update(jparams, jbatch, opt_state, jtarget, jtr)
        jparams, jbatch = jax.device_get((jparams, jbatch))
        jlosses.append(float(loss))
        jgrads.append(tckpt.from_jax_dqn_variables(jax.device_get(g), stats))
        jstats.append(_running(tckpt.from_jax_dqn_variables(jparams, jbatch)))

    policy, target = port_dqn(params, stats), port_dqn(t_params, t_stats)
    target_before = {k: v.clone() for k, v in target.state_dict().items()}
    # the float64 referee of the first update's gradient
    p64, t64 = copy.deepcopy(policy).double().train(), copy.deepcopy(target).double().eval()
    qx, qy = (q.double() for q in p64(t(transition[0]).double()))
    with torch.no_grad():
        tqx, tqy = (q.double() for q in t64(t(transition[2]).double()))
    dqn_loss.dqn_bellman_loss(qx, qy, tqx, tqy, t(transition[1]), t(transition[3]).double(),
                              GAMMA, A).backward()
    grad64 = {k: p.grad.clamp(-1, 1) for k, p in p64.named_parameters()}
    pstate = TrainState(policy, toptim.get_optimizer("rmsprop", policy.parameters()),
                        lambda _: DQN_LR)
    step = rls_train.make_dqn_update_step(A, GAMMA)
    losses, grads, running = [], [], []
    for _ in range(2):
        losses.append(float(step(pstate, target, tuple(t(a) for a in transition))))
        grads.append({k: p.grad.clone() for k, p in policy.named_parameters()})
        running.append(_running({k: v.clone() for k, v in policy.state_dict().items()}))
    return dict(jparams=jparams, jlosses=jlosses, jgrads=jgrads, jstats=jstats,
                policy=policy, target=target, pstate=pstate, losses=losses, grads=grads,
                running=running, grad64=grad64, target_before=target_before, stats=stats,
                start=_running(tckpt.from_jax_dqn_variables(params, stats)))


def _running(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_dqn_update_matches_jax(dqn_updates):
    """The loss of both updates (1e-4 relative). The first update's clamped
    gradient: the heads' to normwise 1e-3 of JAX's; the trunk's runs
    through train-mode BatchNorm's one-pass variance on 0..255 glimpses,
    which is ill-conditioned in float32, so it is held to a float64
    gradient instead, to normwise 2e-2 a tensor (measured 1.5e-2; JAX's own
    sits up to 0.15 from it, in layer4). Every gradient is clamped to ±1,
    and the clamp is active in the second update. The BatchNorm running
    statistics move in each update and agree to normwise 1e-4 after the
    first and 3e-2 after the second, whose forward runs on parameters one
    RMSprop step apart (below; measured 1.6e-2, in layer4's 4×4 maps).
    RMSprop
    moves each weight by up to lr/√(1 − decay) whatever the size of its
    gradient, so a weight whose gradient is near zero may step the other
    way: every weight agrees to 4·lr/√0.1 (two updates, opposite steps) and
    the median to 1% of lr. The target is untouched and in eval mode; then
    ``sync_target`` makes it equal the policy, parameters and buffers."""
    d = dqn_updates
    np.testing.assert_allclose(d["losses"], d["jlosses"], rtol=1e-4)
    for k, g in d["grads"][0].items():
        if k.startswith("f."):
            assert normwise(g, d["grad64"][k]) <= 2e-2, k
        else:
            assert normwise(g, d["jgrads"][0][k]) <= 1e-3, k
    assert all(float(g.abs().max()) <= 1.0 for grads in d["grads"] for g in grads.values())
    assert max(float(g.abs().max()) for g in d["grads"][1].values()) == 1.0
    assert d["pstate"].step == 2 and d["policy"].training and not d["target"].training
    for k, w in d["jstats"][0].items():
        assert normwise(d["running"][0][k], w) <= 1e-4, k
        assert normwise(d["running"][1][k], d["jstats"][1][k]) <= 3e-2, k
        assert not torch.equal(d["running"][0][k], d["start"][k]), k
    got = d["policy"].state_dict()
    want = tckpt.from_jax_dqn_variables(d["jparams"], d["stats"])
    diffs = []
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        diff = np.abs(got[k].numpy() - w.numpy())
        assert diff.max() <= 4 * DQN_LR / np.sqrt(0.1), (k, diff.max())
        diffs.append(diff.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-2 * DQN_LR
    assert all(torch.equal(v, d["target_before"][k]) for k, v in d["target"].state_dict().items())
    rls_train.sync_target(d["policy"], d["target"])
    tsd = d["target"].state_dict()
    assert all(torch.equal(tsd[k], v) for k, v in d["policy"].state_dict().items())


def test_from_jax_dqn_variables_loads_strict(dqn_vars):
    """Every key of the port DQN, heads ``g_x``/``g_y`` included, and no
    other; the trunk's keys are ``from_jax_variables``'s ``f.*``."""
    _, params, stats = dqn_vars
    sd = tckpt.from_jax_dqn_variables(params, stats)
    with torch.device("meta"):
        assert sorted(sd) == sorted(build_dqn("ResNet10", A).state_dict())
    assert sd["g_x.layers.0.weight"].shape == (1024, 512 * 16)
    simclr = tckpt.from_jax_variables({"f": params["f"]}, {"f": stats["f"]})
    assert sorted(k for k in sd if k.startswith("f.")) == sorted(simclr)
    assert all(torch.equal(sd[k], v) for k, v in simclr.items())


# ---------------------------------------------------------------------------
# the driver chain on the CPU: SimCLR → RLS, both resumes


SIMCLR_ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", str(B),
               "--canvas-size", "64", "-f", "2", "-t", "--num-examples", "8", "-p", "1",
               "--epochs", "1", "--device", "cpu"]
RLS_ARGS = ["--dataset", "synthetic", "--backbone", "ResNet10", "--dqn", "ResNet10",
            "-b", str(B), "--canvas-size", "64", "-f", "2", "-t", "--num-examples", "12",
            "-p", "1", "--device", "cpu", "--num-classes", "2", "--enc_layers", "1",
            "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
            "--dim_feedforward", "64", "--num_queries", "5", "-dqnb", "4",
            "--replay-memory-capacity", "6", "--target-update-freq", "1",
            "--num-of-actions", str(A), "--eps-start", "0", "--eps-end", "0"]


@pytest.fixture(scope="module")
def simclr_checkpoint(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("simclr"))
    simclr_driver.main(SIMCLR_ARGS + ["--checkpoint-dir", ck])
    return os.path.join(ck, "checkpoint.pth.tar")


def _dqn_coin_updates(seed, steps, batch, capacity, dqnb):
    """DQN updates the driver takes: the RandomState(seed) coin < 0.7,
    drawn only once the memory holds -dqnb transitions."""
    rs, size, n = np.random.RandomState(seed), 0, 0
    for _ in range(steps):
        size = min(size + batch, capacity)
        n += size >= dqnb and rs.uniform() < 0.7
    return n


def test_driver_chain_trains_checkpoints_and_resumes_on_cpu(simclr_checkpoint, tmp_path,
                                                            capsys, monkeypatch):
    """The RLS driver from the port's SimCLR checkpoint: finite losses,
    ``DQN-Loss``/``Reward`` speed lines, both validation top-1s, the three
    checkpoint files and their keys, the DQN updates the seed's coins give,
    the target synced to the policy. Then ``--resume``/``--dqn-resume``
    with ``--epochs 2``: the first train step of epoch 1 sees every tensor
    of both checkpoints, and (at ε = 0) the policy picks the saccades."""
    ck = str(tmp_path)
    tgs.glimpse_sample.launches = 0
    state, pstate = driver.main([simclr_checkpoint] + RLS_ARGS + ["--checkpoint-dir", ck,
                                                                  "--epochs", "1"])
    out = capsys.readouterr().out
    assert "=> loaded pretrained backbone" in out and "##Policy Top-5" in out
    losses = [float(x) for x in re.findall(r"Loss (\S+) ", out)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert len(re.findall(r"DQN-Loss \S+\tReward \S+", out)) == 3
    assert tgs.glimpse_sample.launches == 0
    expected = _dqn_coin_updates(15, 3, B, 6, 4)
    assert expected > 0 and pstate.step == expected and state.step == 3
    files = {n: os.path.join(ck, n) for n in ("detr_classifier_checkpoint.pth.tar",
                                              "detr_classifier_model_best.pth.tar",
                                              "dqn_checkpoint.pth.tar")}
    assert all(os.path.isfile(f) for f in files.values()), os.listdir(ck)
    detr = tckpt.load_checkpoint(files["detr_classifier_checkpoint.pth.tar"])
    assert sorted(detr) == ["best_prec1", "epoch", "optimizer", "state_dict"]
    assert detr["best_prec1"] > 0
    dqn = tckpt.load_checkpoint(files["dqn_checkpoint.pth.tar"])
    assert sorted(dqn) == ["epoch", "policy_state_dict", "step", "target_state_dict"]
    assert dqn["epoch"] == 1 and dqn["step"] == expected
    assert any(k.endswith("running_var") for k in dqn["policy_state_dict"])
    assert all(torch.equal(dqn["target_state_dict"][k], v)
               for k, v in dqn["policy_state_dict"].items())
    assert all(torch.isfinite(v.float()).all() for v in dqn["policy_state_dict"].values())

    seen = {}
    make = rls_train.make_rls_train_step

    def spy(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(state, dqn_model, images, labels, epoch, draws):
            first = not seen
            if first:
                seen.update(epoch=epoch, step=state.step,
                            opt=copy.deepcopy(state.optimizer.state_dict()),
                            model={k: v.clone() for k, v in state.model.state_dict().items()},
                            policy={k: v.clone() for k, v in dqn_model.state_dict().items()})
            out = step(state, dqn_model, images, labels, epoch, draws)
            if first:
                seen["saccades"] = out[1].saccades
            return out
        return wrapped

    monkeypatch.setattr(rls_train, "make_rls_train_step", spy)
    resumed, rpstate = driver.main([simclr_checkpoint] + RLS_ARGS + [
        "--checkpoint-dir", ck, "--epochs", "2",
        "--resume", files["detr_classifier_checkpoint.pth.tar"],
        "--dqn-resume", files["dqn_checkpoint.pth.tar"]])
    out = capsys.readouterr().out
    assert "=> resumed from" in out and "=> resumed DQN from" in out
    assert seen["epoch"] == 1 and seen["step"] == 3
    assert all(torch.equal(seen["model"][k], v) for k, v in detr["state_dict"].items())
    for i, st in detr["optimizer"]["state"].items():
        assert all(torch.equal(seen["opt"]["state"][i][k], v) for k, v in st.items())
    assert all(torch.equal(seen["policy"][k], v) for k, v in dqn["policy_state_dict"].items())
    bins = seen["saccades"][:, 1:] * A          # ε = 0 at epoch 1: greedy after fixation 0
    assert torch.allclose(bins, bins.round(), atol=1e-4)
    assert resumed.step == 6 and rpstate.step == 2 * expected
    again = tckpt.load_checkpoint(files["dqn_checkpoint.pth.tar"])
    assert again["epoch"] == 2 and again["step"] == 2 * expected


@pytest.mark.parametrize("flag", [["--dqn-resume", "jax.msgpack"]])
def test_driver_refuses_unported_flags(flag, tmp_path):
    """``--multislice`` is ported (``test_torch_port_distributed_drivers.py``),
    and so is a resume from a JAX checkpoint (``test_torch_port_resume.py``):
    any file that is not a torch zip is read as one, and one that lacks a
    key the JAX driver reads is refused, naming the key."""
    flag = [str(tmp_path / f) if f.endswith(".msgpack") else f for f in flag]
    (tmp_path / "jax.msgpack").write_bytes(b"\x81\xa5epoch\x01")   # {"epoch": 1}
    with pytest.raises(ValueError, match="no 'policy_state_dict'"):
        driver.main(["x"] + RLS_ARGS + flag)


def test_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    args = list(RLS_ARGS)
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["x"] + args)
