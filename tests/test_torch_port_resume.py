"""Resuming the port's drivers from the JAX package's own checkpoints.

Each optax state is built by the JAX package's own constructors
(``optimizers.get_optimizer`` with the driver's schedule,
``detr_train.make_detr_optimizer``, ``optax.rmsprop``) on parameters from
``model.init``, moved by 2 ``tx.update``s on seeded numpy gradients (no JAX
driver, no JAX train step), and written with the JAX package's
``save_checkpoint`` under the JAX driver's keys. The port then loads the
file, and:

* its optimizer state equals the file's bit for bit, read through the JAX
  package's own exporters (``export_torch_*_state_dict``), a map
  independent of the port's;
* the next 2 updates from the same fed gradients agree with JAX's: the
  parameters and the optimizer state within 1e-6 normwise in float32
  (``‖port − jax‖ / ‖jax‖`` per tensor; optax's float32 bias correction
  and torch's float64 one round apart by ~1e-7), and the learning rate of
  each update to 1e-6 relative (the port's schedule in float64, optax's in
  float32);
* where the JAX driver starts the optimizer fresh (the SimCLR cross-layout
  case; the RLS DQN, whose file holds no optimizer state) so does the port,
  the schedule at optax's fresh count 0.

Cases: SimCLR under adam, sgd and lars (ResNet10), the cross-layout case
(ResNet-50 ``stat_fusion`` layout from ``model.init``, no update), the
probe, DETR with its clip and three groups, the RLS DQN; then one CPU run
of each of the four port drivers with ``--resume`` of such a file.
"""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multimodal_active_ai_tpu import config as jconfig
from multimodal_active_ai_tpu.models import LogisticRegression as JaxProbe
from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.models import detr as jdetr
from multimodal_active_ai_tpu.models.conv_bn import convert_stat_fusion_variables
from multimodal_active_ai_tpu.models.qnet import build_dqn as jbuild_dqn
from multimodal_active_ai_tpu.train import detr_train as jdetr_train
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train import schedule as jsched
from multimodal_active_ai_tpu.utils import checkpoint as jckpt
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification_rls as rls_driver
from multimodal_active_ai_tpu_torch import representation_evaluation as probe_driver
from multimodal_active_ai_tpu_torch.models import detr as tdetr
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.train import detr_train, optimizers
from multimodal_active_ai_tpu_torch.train import schedule as tschedule
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState, scheduled_update
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

NORMWISE = 1e-6
# Adam, AdamW and LARS (Adam inside) parameters: optax corrects the second moment's bias in
# float32, and 1 − 0.999^c at c = 3, 4 (the resumed updates) carries a
# relative rounding error up to ~2e-5 (measured ~1e-5 after the square
# root: 4.8e-6 normwise); torch.optim.Adam corrects in float64. The port's
# updates are held to 1e-6 of the same updates in float64 as well.
ADAM_NORMWISE = 1e-5
LR_RTOL = 1e-6
# the SimCLR driver's schedule at the CLI runs' sizes (8 examples, b=4,
# 2 epochs, warm-up 1 epoch): counts 0-1 warm up, 2-3 decay
SCHED = dict(global_batch_size=4, num_examples=8, batch_size=4, warmup_epochs=1,
             train_epochs=2)
# base rates (scaled by 4/256) large enough that an update is not lost in
# the rounding of the parameter it moves
BASE_LR = {"adam": 8.0, "sgd": 8.0, "lars": 64.0}
F_PROBE, F_DETR, CLASSES, A = 2, 3, 10, 10
DETR_FLAGS = ["--dataset", "synthetic", "--backbone", "ResNet10", "--num-classes", "10",
              "-f", str(F_DETR), "--enc_layers", "2", "--dec_layers", "2", "--hidden_dim",
              "32", "--nheads", "2", "--dim_feedforward", "64"]
CPU = ["--device", "cpu"]


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


def _grads(tree, seed):
    """Seeded float32 gradients in a parameter tree's shapes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(model, *args, seed=0, **kw):
    """The tree ``model.init`` returns (its shapes from ``eval_shape``,
    which compiles nothing), with seeded float32 values: kernels by their
    fan-in, scales and variances near 1, the rest small."""
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


def _adam64(p, m, v, count, grads, lrs):
    """optax's Adam update of one tensor in float64, from the file's
    float32 state: the float64 twin of what both sides compute."""
    p, m, v = (np.asarray(x, np.float64) for x in (p, m, v))
    for g, lr in zip(grads, lrs):
        count += 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * np.square(np.float64(g))
        p = p - lr * (m / (1 - 0.9 ** count)) / (np.sqrt(v / (1 - 0.999 ** count)) + 1e-8)
    return p


def _normwise(got, ref):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _run_jax(tx, params, seeds=(1, 2, 3, 4), opt_state=None):
    """``tx.update`` on each seed's gradients (one jitted update); returns
    the parameters and the optax state after the first 2 updates (what the
    file holds) and after all of them."""
    opt_state = tx.init(params) if opt_state is None else opt_state

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    out = []
    for seed in seeds:
        params, opt_state = update(params, opt_state, _grads(params, seed))
        out.append((_np(params), _np(opt_state)))
    return out[1] + out[-1]


def _sd(opt_state):
    """An optax state as the JAX package's checkpoints hold it."""
    return serialization.to_state_dict(opt_state)


def _write(path, payload):
    jckpt.save_checkpoint(payload, False, filename=str(path))
    return str(path)


def _feed(model, grads: dict):
    """Set every parameter's gradient from a port-layout tree."""
    for name, p in model.named_parameters():
        p.grad = grads[name].clone()


def _assert_state(opt, model, want: dict, step=None):
    """Every parameter's optimizer state is ``want[key][name]`` bit for bit."""
    for name, p in model.named_parameters():
        if name not in want[next(iter(want))]:
            assert p not in opt.state
            continue
        st = opt.state[p]
        for key, tree in want.items():
            assert torch.equal(st[key], torch.from_numpy(np.asarray(tree[name]))), (key, name)
        if step is not None:
            assert float(st["step"]) == step and (type(st["step"]) is int) == (
                isinstance(opt, optimizers.LARCAdam)), name


def _assert_close(model, opt, want_params: dict, want_state: dict, tol=NORMWISE):
    for name, p in model.named_parameters():
        assert _normwise(p, want_params[name]) <= tol, name
        for key, tree in want_state.items():
            if name in tree:
                assert _normwise(opt.state[p][key], tree[name]) <= NORMWISE, (key, name)


# ---------------------------------------------------------------------------
# SimCLR


@pytest.fixture(scope="module")
def simclr_vars():
    return _init(JaxSimCLR(arch="ResNet10", axis_name=None), jnp.ones((2, 30, 30, 12)),
                 train=False)


def _simclr_payload(variables, params, opt_state, step):
    return {"epoch": 1, "step": step, "state_dict": {"params": params,
                                                     "batch_stats": variables["batch_stats"]},
            "best_prec1": 1.5, "optimizer": opt_state,
            "loss_history": np.asarray([4.5], np.float64),
            "top1_acc_history": np.asarray([1.5], np.float64),
            "top5_acc_history": np.asarray([6.0], np.float64),
            "total_time": {"val": 0.5, "avg": 0.5, "sum": 0.5, "count": 1.0}}


@pytest.fixture(scope="module")
def simclr_files(simclr_vars, tmp_path_factory):
    """For each of adam, sgd and lars: the file after 2 JAX updates, and
    JAX's parameters, state and learning rates over 2 more."""
    out = {}
    d = tmp_path_factory.mktemp("simclr")
    for kind, lr in BASE_LR.items():
        sched = jsched.simclr_learning_rate(lr, **SCHED)
        tx = joptim.get_optimizer(kind, sched, 0.9, 1e-4)
        params, state, after, after_state = _run_jax(tx, simclr_vars["params"])
        path = _write(d / f"{kind}.msgpack", _simclr_payload(simclr_vars, params, state, 2))
        out[kind] = SimpleNamespace(path=path, after=after, after_state=_sd(after_state),
                                    lrs=[float(sched(c)) for c in (2, 3)])
    return out


def _check_adam64(model, before: dict, opt_state: dict, to_port, grads, lrs, count):
    """Each parameter after the resumed Adam updates against
    :func:`_adam64` from the file's parameters ``before`` and state."""
    mu, nu = to_port(opt_state["0"]["mu"]), to_port(opt_state["0"]["nu"])
    for name, p in model.named_parameters():
        want = _adam64(before[name], mu[name], nu[name], count,
                       [g[name].double().numpy() for g in grads], lrs)
        assert _normwise(p, want) <= NORMWISE, name


_MOMENTS = {"adam": {"exp_avg": ("0", "mu"), "exp_avg_sq": ("0", "nu")},
            "lars": {"exp_avg": ("0", "mu"), "exp_avg_sq": ("0", "nu")},
            "sgd": {"momentum_buffer": ("1", "0", "trace")}}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _simclr_export(tree, stats):
    return jckpt.export_torch_simclr_state_dict(tree, stats)


def _port_simclr(stat_fusion=None, arch="ResNet10"):
    with torch.device("meta"):
        model = SimCLRModule(arch=arch, stat_fusion=stat_fusion)
    return model.to_empty(device="cpu")


@pytest.mark.parametrize("kind", ["adam", "sgd", "lars"])
def test_simclr_resumes_the_optax_state(kind, simclr_files, simclr_vars):
    case = simclr_files[kind]
    payload = jckpt.load_checkpoint(case.path)
    model = _port_simclr()
    opt = optimizers.get_optimizer(kind, model.parameters(), 0.9, 1e-4)
    cfg = SimpleNamespace(stat_fusion=None, optimizer=kind, resume=case.path)
    count = simclr_driver.resume_jax(cfg, payload, model, opt)
    stats = simclr_vars["batch_stats"]
    assert count == 2
    want = _simclr_export(payload["state_dict"]["params"], stats)
    assert all(torch.equal(v, torch.from_numpy(want[k])) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    moments = {key: _simclr_export(_at(payload["optimizer"], path), stats)
               for key, path in _MOMENTS[kind].items()}
    _assert_state(opt, model, moments, None if kind == "sgd" else 2)

    state = TrainState(model, opt, tschedule.simclr_learning_rate(BASE_LR[kind], **SCHED),
                       step=int(payload["step"]), count=count)
    to_port = lambda tree: tckpt.from_jax_variables(tree, None)   # noqa: E731
    before = to_port(payload["state_dict"]["params"])
    grads = [to_port(_grads(payload["state_dict"]["params"], seed)) for seed in (3, 4)]
    lrs = []
    for g in grads:
        _feed(model, g)
        scheduled_update(state)
        lrs.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(lrs, case.lrs, rtol=LR_RTOL)
    assert state.step == state.count == 4
    _assert_close(model, opt, _simclr_export(case.after, stats),
                  {key: _simclr_export(_at(case.after_state, path), stats)
                   for key, path in _MOMENTS[kind].items()},
                  NORMWISE if kind == "sgd" else ADAM_NORMWISE)
    if kind == "adam":
        _check_adam64(model, before, payload["optimizer"], to_port, grads, lrs, 2)


def test_simclr_cross_layout_resume_starts_the_optimizer_fresh(tmp_path, capsys):
    """A ResNet-50 file in the ``stat_fusion`` (``FusedConv1x1BN``) layout,
    resumed without ``--stat-fusion``: the weights convert, the optimizer
    starts fresh and its schedule restarts at optax's count 0 while
    ``step`` carries on, as in the JAX driver. Under ``--stat-fusion gram``
    the layouts agree and the moments carry, through the fused → unfused
    map (held against the JAX package's own converter and exporter)."""
    variables = _init(JaxSimCLR(arch="ResNet50", axis_name=None, stat_fusion="gram"),
                      jnp.ones((2, 30, 30, 12)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    sched = jsched.simclr_learning_rate(1.0, **{**SCHED, "warmup_epochs": 0})
    adam, scale = joptim.get_optimizer("adam", sched).init(params)
    opt_state = (adam._replace(count=np.int32(3), mu=_grads(params, 5), nu=jax.tree.map(
        np.abs, _grads(params, 6))), scale._replace(count=np.int32(3)))
    path = _write(tmp_path / "r50.msgpack", _simclr_payload(variables, params, opt_state, 7))
    payload = tckpt.load_checkpoint(path)
    model = _port_simclr(arch="ResNet50")
    opt = optimizers.get_optimizer("adam", model.parameters())
    cfg = SimpleNamespace(stat_fusion=None, optimizer="adam", resume=path)
    count = simclr_driver.resume_jax(cfg, payload, model, opt)
    assert "optimizer state starts fresh" in capsys.readouterr().out
    assert count == 0 and not opt.state
    unfused = convert_stat_fusion_variables(variables, to_fused=False)
    want = jckpt.export_torch_simclr_state_dict(unfused["params"], unfused["batch_stats"])
    assert sorted(model.state_dict()) == sorted(want)
    assert all(torch.equal(v, torch.from_numpy(want[k])) for k, v in model.state_dict().items())

    state = TrainState(model, opt, tschedule.simclr_learning_rate(
        1.0, **{**SCHED, "warmup_epochs": 0}), step=7, count=count)
    name, p = next(iter(model.named_parameters()))
    p.grad = torch.ones_like(p)
    scheduled_update(state)
    assert state.step == 8 and state.count == 1
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(0)), rtol=LR_RTOL)
    assert float(sched(0)) != float(sched(7))

    opt = optimizers.get_optimizer("adam", model.parameters())
    cfg.stat_fusion = "gram"
    assert simclr_driver.resume_jax(cfg, payload, model, opt) == 3
    moments = {}
    for key, slot in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        tree = convert_stat_fusion_variables({"params": payload["optimizer"]["0"][slot],
                                              "batch_stats": stats}, to_fused=False)
        moments[key] = jckpt.export_torch_simclr_state_dict(tree["params"], unfused["batch_stats"])
    _assert_state(opt, model, moments, 3)


# ---------------------------------------------------------------------------
# the probe, DETR, the DQN


@pytest.fixture(scope="module")
def probe_case(tmp_path_factory):
    feat = 512 * 16 * F_PROBE
    params = _init(JaxProbe(num_classes=CLASSES), jnp.ones((2, feat)), seed=1)["params"]
    sched = jsched.simclr_learning_rate(8.0, **SCHED)
    tx = joptim.get_optimizer("adam", sched)
    params, state, after, after_state = _run_jax(tx, params, (11, 12, 13, 14))
    path = _write(tmp_path_factory.mktemp("probe") / "classifier_checkpoint.msgpack",
                  {"epoch": 1, "step": 2, "state_dict": params, "best_prec1": 2.5,
                   "optimizer": state})
    return SimpleNamespace(path=path, params=params, after=after, after_state=_sd(after_state),
                           lrs=[float(sched(c)) for c in (2, 3)])


def test_probe_resumes_the_optax_state(probe_case):
    payload = tckpt.load_checkpoint(probe_case.path)
    probe = LogisticRegression(512 * 16 * F_PROBE, CLASSES)
    opt = optimizers.get_optimizer("adam", probe.parameters())
    count = tckpt.resume_jax_probe(payload, probe, opt, "adam", F_PROBE, probe_case.path)
    exp = lambda t: jckpt.export_torch_classifier_state_dict(t, F_PROBE)
    assert count == 2
    assert all(torch.equal(v, torch.from_numpy(exp(probe_case.params)[k]))
               for k, v in probe.state_dict().items())
    _assert_state(opt, probe, {"exp_avg": exp(payload["optimizer"]["0"]["mu"]),
                               "exp_avg_sq": exp(payload["optimizer"]["0"]["nu"])}, 2)
    state = TrainState(probe, opt, tschedule.simclr_learning_rate(8.0, **SCHED), 2, count)
    to_port = lambda tree: tckpt.from_jax_probe_variables(tree, F_PROBE)   # noqa: E731
    grads = [to_port(_grads(probe_case.params, seed)) for seed in (13, 14)]
    lrs = []
    for g in grads:
        _feed(probe, g)
        scheduled_update(state)
        lrs.append(opt.param_groups[0]["lr"])
    np.testing.assert_allclose(lrs, probe_case.lrs, rtol=LR_RTOL)
    _assert_close(probe, opt, exp(probe_case.after),
                  {"exp_avg": exp(probe_case.after_state["0"]["mu"]),
                   "exp_avg_sq": exp(probe_case.after_state["0"]["nu"])}, ADAM_NORMWISE)
    _check_adam64(probe, to_port(probe_case.params), payload["optimizer"], to_port, grads,
                  lrs, 2)


DETR_LR, DETR_LR_BB, DETR_WD, DETR_CLIP = 1e-2, 1e-3, 1e-4, 0.1


@pytest.fixture(scope="module")
def detr_case(tmp_path_factory):
    """The JAX DETR of the CLI run's flags, AdamW groups with the clip;
    StepLR every 2 counts (1 step an epoch, ``lr_drop`` 2), so the resumed
    updates run at the dropped rate."""
    jcfg = jconfig.parse_into(jconfig.DETRConfig, ["none", "none"] + DETR_FLAGS)
    model, _ = jdetr.build(jcfg, num_classes=CLASSES)
    variables = _init(model, jnp.ones((2, F_DETR, 30, 30, 12)), jnp.full((2, F_DETR, 2), 0.5),
                      seed=2)
    tx = jdetr_train.make_detr_optimizer(variables["params"], DETR_LR, DETR_LR_BB, DETR_WD,
                                         DETR_CLIP, 2, 1, pretrained_backbone=True)
    params, state, after, after_state = _run_jax(tx, variables["params"], (21, 22, 23, 24))
    path = _write(tmp_path_factory.mktemp("detr") / "detr_classifier_checkpoint.msgpack",
                  {"epoch": 1, "step": 2, "state_dict": {"params": params,
                                                         "batch_stats": variables["batch_stats"]},
                   "best_prec1": 3.5, "optimizer": state})
    return SimpleNamespace(path=path, params=params, stats=variables["batch_stats"],
                           after=after, after_state=_sd(after_state))


def _detr_export(tree, like, stats):
    return jckpt.export_torch_detr_state_dict(tckpt.fill_masked(tree, like), stats)


def test_detr_resumes_the_optax_state_of_its_groups(detr_case):
    payload = tckpt.load_checkpoint(detr_case.path)
    cfg = tconfig.parse_into(tconfig.DETRConfig, DETR_FLAGS)
    with torch.device("meta"):
        model, _ = tdetr.build(cfg, num_classes=CLASSES)
    model = model.to_empty(device="cpu")
    opt = detr_train.make_detr_optimizer(model, DETR_LR, DETR_LR_BB, DETR_WD)
    count = tckpt.resume_jax_detr(payload, model, opt, True, detr_case.path)
    assert count == 2
    params, stats = detr_case.params, detr_case.stats
    want = _detr_export(params, params, stats)
    assert sorted(model.state_dict()) == sorted(want)
    assert all(torch.equal(v, torch.from_numpy(want[k])) for k, v in model.state_dict().items())
    inner = payload["optimizer"]["1"]["inner_states"]
    labels = detr_train.detr_param_labels(model)
    for group in opt.param_groups:
        chain = inner[group["name"]]["inner_state"]
        moments = {k: _detr_export(chain["0"][m], params, stats)
                   for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
        for name, p in model.named_parameters():
            if labels[name] == group["name"]:
                for k, tree in moments.items():
                    assert torch.equal(opt.state[p][k], torch.from_numpy(tree[name])), name
                assert float(opt.state[p]["step"]) == 2
    frozen = [p for n, p in model.named_parameters() if labels[n] == "frozen"]
    assert frozen and not any(p in opt.state for p in frozen)

    state = TrainState(model, opt, detr_train.step_lr(1, 2), step=2, count=count)
    lrs = []
    for seed in (23, 24):
        _feed(model, tckpt.from_jax_detr_variables(_grads(params, seed), None))
        norm = detr_train.update_from_grads(state, DETR_CLIP)
        assert norm > DETR_CLIP                       # the clip is active
        lrs.append({g["name"]: g["lr"] for g in opt.param_groups})
    want_lrs = {"head": DETR_LR * 0.1, "backbone": DETR_LR_BB * 0.1}   # StepLR at counts 2, 3
    for lr in lrs:
        assert lr.keys() == want_lrs.keys()
        for k in lr:
            np.testing.assert_allclose(lr[k], want_lrs[k], rtol=LR_RTOL)
    after = _detr_export(detr_case.after, params, stats)
    for name, p in model.named_parameters():
        assert _normwise(p, after[name]) <= ADAM_NORMWISE, name
    for group in opt.param_groups:
        chain = detr_case.after_state["1"]["inner_states"][group["name"]]["inner_state"]
        assert int(chain["2"]["count"]) == 4
        mu = _detr_export(chain["0"]["mu"], params, stats)
        for name, p in model.named_parameters():
            if labels[name] == group["name"]:
                assert _normwise(opt.state[p]["exp_avg"], mu[name]) <= NORMWISE, name


@pytest.fixture(scope="module")
def dqn_case(tmp_path_factory):
    model = jbuild_dqn("ResNet10", A, norm_kind="bn", axis_name=None)
    variables, target = (_init(model, jnp.ones((2, 30, 30, 12)), train=False, seed=seed)
                         for seed in (3, 4))
    path = _write(tmp_path_factory.mktemp("dqn") / "dqn_checkpoint.msgpack", {
        "epoch": 1, "step": 5, "policy_state_dict": variables["params"],
        "policy_batch_stats": variables["batch_stats"],
        "target_state_dict": target["params"], "target_batch_stats": target["batch_stats"]})
    # the JAX driver's RMSprop starts fresh on a resume: 2 updates from init
    _, _, after, _ = _run_jax(joptim.get_optimizer("rmsprop", 1e-3), variables["params"],
                              (31, 32))
    return SimpleNamespace(path=path, variables=variables, target=target, after=after)


def test_dqn_resumes_the_weights_and_starts_rmsprop_fresh(dqn_case):
    payload = tckpt.load_checkpoint(dqn_case.path)
    policy_sd, target_sd, step = tckpt.jax_dqn_state_dicts(payload, dqn_case.path)
    v, t = dqn_case.variables, dqn_case.target
    assert step == 5
    for got, (p, s) in ((policy_sd, (v["params"], v["batch_stats"])),
                        (target_sd, (t["params"], t["batch_stats"]))):
        want = tckpt.from_jax_dqn_variables(p, s)
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in got)
    with torch.device("meta"):
        policy = build_dqn("ResNet10", A)
    policy = policy.to_empty(device="cpu")
    tckpt.load_converted(policy, lambda: policy_sd, dqn_case.path, "DQN")
    opt = optimizers.get_optimizer("rmsprop", policy.parameters())
    state = TrainState(policy, opt, lambda _: 1e-3, step=step)
    assert not opt.state
    for seed in (31, 32):
        _feed(policy, tckpt.from_jax_dqn_variables(_grads(v["params"], seed), None))
        scheduled_update(state)
    want = tckpt.from_jax_dqn_variables(dqn_case.after, None)
    for name, p in policy.named_parameters():
        assert _normwise(p, want[name]) <= NORMWISE, name
    assert state.step == 7


def test_a_constant_rate_adam_state_is_refused(simclr_vars, tmp_path):
    """optax's ``adam(1e-3)`` keeps no schedule count: not the driver's
    chain, refused as ``restore_like`` refuses it (and a chain's states are
    matched by number: '10' after '9')."""
    params = simclr_vars["params"]
    path = _write(tmp_path / "c.msgpack", _simclr_payload(
        simclr_vars, params, optax.adam(1e-3).init(params), 0))
    model = _port_simclr()
    opt = optimizers.get_optimizer("adam", model.parameters())
    with pytest.raises(ValueError, match="no '1/count'"):
        tckpt.resume_jax_simclr(tckpt.load_checkpoint(path), model, opt, "adam", False, path)
    with pytest.raises(ValueError, match=re.escape("['0', '2', '10']")):
        optimizers._check_keys({"10": {}, "2": {}, "0": {}}, ("0", "1"), "adam")


# ---------------------------------------------------------------------------
# the four drivers on the CPU


def test_the_four_drivers_resume_a_jax_msgpack(simclr_files, probe_case, detr_case, dqn_case,
                                               tmp_path, capsys):
    simclr = simclr_files["adam"].path
    state = simclr_driver.main([
        "--dataset", "synthetic", "--arch", "ResNet10", "-b", "4", "--canvas-size", "64",
        "-f", "2", "--epochs", "2", "-t", "--num-examples", "8",
        "--checkpoint-dir", str(tmp_path / "s"), "--resume", simclr]
        + CPU)
    out = capsys.readouterr().out
    assert "=> loaded checkpoint" in out and "Epoch: [1][0/2]" in out
    assert state.step == state.count == 2 + 2 * 2
    saved = tckpt.load_checkpoint(str(tmp_path / "s" / "checkpoint.pth.tar"))
    assert saved["count"] == saved["step"] == 6 and saved["loss_history"][0] == 4.5

    probe = probe_driver.main([
        simclr, "--dataset", "synthetic", "--arch", "ResNet10", "-b", "4", "--canvas-size",
        "64", "-f", str(F_PROBE), "--epochs", "2", "-t", "--num-examples", "8",
        "--num-classes", "10", "--checkpoint-dir", str(tmp_path / "p"),
        "--resume", probe_case.path] + CPU)
    assert "=> resumed classifier" in capsys.readouterr().out
    assert probe.step == probe.count == 2 + 2

    common = DETR_FLAGS + ["-b", "4", "--canvas-size", "64", "--epochs", "2", "-t",
                           "--num-examples", "8"] + CPU
    detr = detr_driver.main([simclr] + common + ["--checkpoint-dir", str(tmp_path / "d"),
                                                 "--resume", detr_case.path])
    assert "=> resumed from" in capsys.readouterr().out and detr.step == detr.count == 4

    state, pstate = rls_driver.main([simclr] + common + [
        "--dqn", "ResNet10", "--num-of-actions", str(A), "-dqnb", "4",
        "--replay-memory-capacity", "16", "--target-update-freq", "1",
        "--checkpoint-dir", str(tmp_path / "r"), "--resume", detr_case.path,
        "--dqn-resume", dqn_case.path])
    out = capsys.readouterr().out
    assert "=> resumed from" in out and "=> resumed DQN from" in out
    assert state.step == 4 and pstate.step >= 5
    saved = tckpt.load_checkpoint(str(tmp_path / "r" / "dqn_checkpoint.pth.tar"))
    assert saved["epoch"] == 2 and saved["step"] == pstate.step


# ---------------------------------------------------------------------------
# chip_smoke.py's JAX-layout writer (its phase 3i runs where there is no JAX)


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(root)


def test_chip_smoke_msgpack_writer_is_flax_byte_for_byte(chip_smoke):
    """Every kind of value a JAX checkpoint holds, at every msgpack width
    edge: the same bytes as ``flax.serialization.msgpack_serialize``."""
    rng = np.random.default_rng(0)
    tree = {"b": {"z": rng.standard_normal((3, 4)).astype(np.float32), "a": np.int32(7)},
            "count": np.asarray(30, np.int32), "ints": [0, 127, 128, 255, 256, 65535, 65536,
                                                         2**32, -1, -32, -33, -128, -129,
                                                         -2**15 - 1, -2**31 - 1],
            "f": 1.5, "s": "x" * 40, "long": "y" * 300, "none": None, "flag": True,
            "empty": {}, "big": rng.standard_normal(70000).astype(np.float32),
            "hist": np.asarray([4.5, 3.25], np.float64), "u8": np.arange(5, dtype=np.uint8),
            **{f"k{i}": i for i in range(20)}}
    got = chip_smoke.flax_msgpack_bytes(tree)
    assert got == serialization.msgpack_serialize(tree)
    _same(tckpt.flax_msgpack.msgpack_restore(got), serialization.msgpack_restore(got))


def _same(got, ref):
    """The same tree: keys (in any order), dtypes and bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref)
        for k in ref:
            _same(got[k], ref[k])
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and np.asarray(got).tobytes() == np.asarray(ref).tobytes()
    else:
        assert got == ref


@pytest.mark.parametrize("arch", ["ResNet10", "ResNet50"])
def test_chip_smoke_jax_layout_is_the_jax_packages(chip_smoke, arch):
    """``to_jax_simclr`` (the inverse of ``from_jax_variables``) gives what
    the JAX package's own ``import_torch_simclr_state_dict`` gives, bit for
    bit, for a BasicBlock and a Bottleneck arch (their downsample slots
    differ), and its parameters-only form maps the same leaves."""
    variables = _init(JaxSimCLR(arch=arch, axis_name=None), jnp.ones((2, 30, 30, 12)),
                      train=False, seed=7)
    sd = tckpt.from_jax_variables(variables["params"], variables["batch_stats"])
    params, stats = chip_smoke.to_jax_simclr(sd)
    ref_p, ref_s = jckpt.import_torch_simclr_state_dict(
        {k: v.numpy() for k, v in sd.items()}, variables["params"], variables["batch_stats"])
    _same(params, jax.tree.map(np.asarray, ref_p))
    _same(stats, jax.tree.map(np.asarray, ref_s))
    _same(chip_smoke.to_jax_simclr(sd, with_stats=False), params)


def test_chip_smoke_payload_reads_back_and_resumes(chip_smoke, simclr_vars, tmp_path):
    """The JAX-layout payload of a port checkpoint after Adam updates,
    written by ``flax_msgpack_bytes``, reads back through flax and through
    the port's reader alike, and resuming it restores the port's own state
    bit for bit."""
    model = _port_simclr()
    model.load_state_dict(tckpt.from_jax_variables(simclr_vars["params"],
                                                   simclr_vars["batch_stats"]))
    opt = optimizers.get_optimizer("adam", model.parameters())
    state = TrainState(model, opt, lambda c: 1e-3)
    for seed in (1, 2):
        _feed(model, tckpt.from_jax_variables(_grads(simclr_vars["params"], seed), None))
        scheduled_update(state)
    sd = model.state_dict()
    payload = {"epoch": 1, "step": 2, "count": 2, "state_dict": sd, "best_prec1": 0.5,
               "optimizer": opt.state_dict(), "loss_history": [4.0],
               "top1_acc_history": [0.5], "top5_acc_history": [2.5],
               "total_time": {"val": 1.0, "avg": 1.0, "sum": 1.0, "count": 1.0}}
    data = chip_smoke.flax_msgpack_bytes(chip_smoke.jax_simclr_payload(torch, payload, model))
    restored = serialization.msgpack_restore(data)
    _same(tckpt.flax_msgpack.msgpack_restore(data), restored)
    assert int(restored["optimizer"]["1"]["count"]) == 2
    path = str(tmp_path / "c.msgpack")
    with open(path, "wb") as f:
        f.write(data)
    fresh = _port_simclr()
    fresh_opt = optimizers.get_optimizer("adam", fresh.parameters())
    assert tckpt.resume_jax_simclr(tckpt.load_checkpoint(path), fresh, fresh_opt, "adam",
                                   False, path) == 2
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    for (_, p), (_, q) in zip(model.named_parameters(), fresh.named_parameters()):
        assert all(torch.equal(opt.state[p][k], fresh_opt.state[q][k])
                   for k in ("step", "exp_avg", "exp_avg_sq"))
