"""The PyTorch port's trainer against the JAX package's, and its driver.

The whole SimCLR train step (ResNet10, B=4, F=2, canvas 64, float32) runs
on both sides from the same weights, images and random draws: the JAX step
samples its augmentation parameters and noise from its key, and the test
recomputes those draws from the same key and hands them to the port. Then
the schedule, the optimizers, the eval step and ``contrastive_learning``
end to end on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train import schedule as jsched
from multimodal_active_ai_tpu.train import simclr_train as jtrain
from multimodal_active_ai_tpu_torch import contrastive_learning as driver
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import optimizers as toptim
from multimodal_active_ai_tpu_torch.train import schedule as tsched
from multimodal_active_ai_tpu_torch.train import simclr_train as ttrain
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, T = 4, 2, 0.05
# lr 0.01 linearly scaled to batch 4, no warmup: lr(0) = 1.5625e-4 != 0
LR_ARGS = (0.01, B, 16, B, 0, 5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _views(key, n_views, src):
    """The per-view AugParams and noise that ``jax.random`` gives a step's
    view keys ``(kp, kn)``, as the port's tensors."""
    cfg = jr.RetinaConfig(**GEOM)
    g, ch = cfg.glimpse_size, cfg.num_channels
    params, noise = [], []
    for kp, kn in key[:n_views]:
        p = jr.sample_unlabeled_params(kp, B, src, cfg)
        params.append(tr.AugParams(*[_t(x) for x in p]))
        nz = jax.vmap(lambda k: jax.random.normal(k, (g, g, ch)))(jax.random.split(kn, B))
        noise.append(_t(nz))
    return params, noise


@pytest.fixture(scope="module")
def trained():
    """One JAX train step and one eval step, and the port's, from equal
    weights, images and draws."""
    model = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    tx = joptim.get_optimizer("adam", jsched.simclr_learning_rate(*LR_ARGS))
    state0 = jtrain.create_train_state(model, tx, jax.random.PRNGKey(0),
                                       jnp.ones((2, 30, 30, 12)))
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jcfg = jr.RetinaConfig(**GEOM)
    images = np.random.default_rng(1).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(2)
    step = jtrain.make_train_step(model, mesh, jcfg, F, T, donate=False)
    state1, metrics = step(state0, jnp.asarray(images), key)
    ekey = jax.random.PRNGKey(3)
    ev = jtrain.make_eval_step(model, mesh, jcfg, T)(state1, jnp.asarray(images), ekey)

    port = SimCLRModule(arch="ResNet10")
    port.load_state_dict(tckpt.from_jax_variables(
        jax.device_get(state0.params), jax.device_get(state0.batch_stats)))
    tstate = ttrain.TrainState(port, toptim.get_optimizer("adam", port.parameters()),
                               tsched.simclr_learning_rate(*LR_ARGS))
    tcfg = tr.RetinaConfig(**GEOM)
    fix_keys = jax.random.split(key, 2 * (F + 1)).reshape(F + 1, 2, 2)
    params, noise = _views(fix_keys, F + 1, 64)
    losses = ttrain.make_train_step(tcfg, F, T)(tstate, _t(images), params=params,
                                                noise=noise)
    ks = jax.random.split(ekey, 4).reshape(2, 2, 2)
    eparams, enoise = _views(ks, 2, 64)
    tev = ttrain.make_eval_step(tcfg, T)(tstate, _t(images), params=eparams,
                                         noise=enoise)
    return dict(jax_losses=np.asarray(metrics["losses"]), losses=losses,
                jax_sd=tckpt.from_jax_variables(jax.device_get(state1.params),
                                                jax.device_get(state1.batch_stats)),
                state=tstate, jax_eval=jax.device_get(ev), eval=tev,
                lr=tsched.simclr_learning_rate(*LR_ARGS)(0))


# ---------------------------------------------------------------------------
# the whole train step


def test_train_step_losses_match_jax(trained):
    """The per-fixation losses. Two f32 effects separate them: a sampling
    coordinate 1 ulp apart can move a bf16 y weight across a rounding step
    (a few glimpse elements differ by <1 in ~500, see the retina tests), and
    the gradient through BatchNorm's one-pass variance on un-centred
    0..255 glimpses is ill-conditioned (both sides' f32 gradients sit
    ~1e-2 from a float64 one in the early layers). NT-Xent at T=0.05
    amplifies projection differences ~20x. Measured 3.7e-4 relative."""
    losses = trained["losses"]
    assert losses.shape == (F,) and not losses.requires_grad
    np.testing.assert_allclose(losses.numpy(), trained["jax_losses"], rtol=2e-3)
    assert trained["state"].step == F


def test_train_step_final_params_match_jax(trained):
    """After F Adam updates. Adam's first steps move each weight by about
    ``lr`` whatever the size of its gradient, so a weight whose gradient
    differs in sign (within rounding of zero) or in ratio between steps may
    step differently: every weight agrees to ``2·lr·F``, the median weight
    to 1% of ``lr``, and at most 5% of weights differ by more than
    ``lr/10`` (measured: 2.7%). BatchNorm running statistics of the
    ``1 + F`` train-mode forwards agree to 0.5% of each tensor's largest
    value (measured: 0.11%)."""
    got = trained["state"].model.state_dict()
    want = trained["jax_sd"]
    lr = trained["lr"]
    assert lr > 0
    diffs = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].numpy() - w.numpy())
        if k.endswith(("running_mean", "running_var")):
            assert d.max() <= 5e-3 * np.abs(w.numpy()).max(), k
            continue
        assert d.max() <= 2 * lr * F * (1 + 1e-3), (k, d.max())
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.median(diffs) <= 1e-2 * lr
    assert (diffs > 0.1 * lr).mean() <= 0.05
    assert int(got["f.bn1.num_batches_tracked"]) == 1 + F


# ---------------------------------------------------------------------------
# the eval step


def test_eval_step_matches_jax(trained):
    ev, ref = trained["eval"], trained["jax_eval"]
    # the same glimpse and float32 effects as the train-step losses
    np.testing.assert_allclose(float(ev["loss"]), float(ref["loss"]), rtol=2e-3)
    assert float(ev["top1"]) == pytest.approx(float(ref["top1"]))
    assert float(ev["top5"]) == pytest.approx(float(ref["top5"]))
    assert not trained["state"].model.training


# ---------------------------------------------------------------------------
# schedule and optimizers


@pytest.mark.parametrize("args", [
    (0.01, 256, 1000, 32, 2, 10, "linear"),   # warmup then cosine
    (0.3, 64, 500, 64, 0, 3, "sqrt"),         # no warmup
])
def test_schedule_matches_jax(args):
    ref = jsched.simclr_learning_rate(*args[:6], scaling=args[6])
    got = tsched.simclr_learning_rate(*args[:6], scaling=args[6])
    for step in [0, 1, 5, 31, 62, 63, 64, 100, 400, 1000]:
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12)
    if args[4]:
        assert got(0) == 0.0


@pytest.mark.parametrize("name", ["sgd", "adam", "lars"])
def test_optimizer_updates_match_optax(name):
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched = tsched.simclr_learning_rate(0.1, 256, 100, 10, 1, 5)
    tx = joptim.get_optimizer(name, jsched.simclr_learning_rate(0.1, 256, 100, 10, 1, 5),
                              momentum=0.9, weight_decay=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = toptim.get_optimizer(name, list(tp.values()), momentum=0.9, weight_decay=1e-2)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(g[k])
        toptim.set_learning_rate(opt, sched(i))
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        toptim.get_optimizer("adagrad", list(tp.values()))


# ---------------------------------------------------------------------------
# contrastive_learning end to end on the CPU, and no silent CPU fallback

DRIVER_ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", str(B),
               "--canvas-size", "64", "-f", str(F), "-t", "--num-examples", "8",
               "-p", "1", "--no-bf16"]


def test_driver_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path)
    tgs.glimpse_sample.launches = 0
    state = driver.main(DRIVER_ARGS + ["--epochs", "1", "--device", "cpu",
                                       "--checkpoint-dir", ck,
                                       "--export-torch", os.path.join(ck, "ref.pth.tar")])
    out = capsys.readouterr().out
    assert "Epoch: [0][1/2]" in out and "##Perf" in out
    assert state.step == 2 * F            # 2 batches of 8 examples, F updates each
    assert tgs.glimpse_sample.launches == 0   # CPU tensors take the plain version
    payload = tckpt.load_checkpoint(os.path.join(ck, "checkpoint.pth.tar"))
    assert payload["epoch"] == 1 and payload["step"] == 2 * F
    assert np.isfinite(payload["loss_history"]).all()
    assert os.path.isfile(os.path.join(ck, "model_best.pth.tar")) == (
        payload["best_prec1"] > 0)
    exported = tckpt.load_checkpoint(os.path.join(ck, "ref.pth.tar"))
    assert sorted(exported["state_dict"]) == sorted(state.model.state_dict())

    resumed = driver.main(DRIVER_ARGS + ["--epochs", "2", "--device", "cpu",
                                         "--checkpoint-dir", ck, "--resume",
                                         os.path.join(ck, "checkpoint.pth.tar")])
    out = capsys.readouterr().out
    assert "=> loaded checkpoint" in out and "Epoch: [1][0/2]" in out
    assert resumed.step == 4 * F


@pytest.mark.parametrize("flag", [["--resume", "jax.msgpack"], ["--unroll-fixations", "2"]])
def test_driver_refuses_unported_flags(flag, tmp_path):
    """``--multislice`` is ported (``test_torch_port_distributed_drivers.py``),
    and so is a resume from a JAX checkpoint (``test_torch_port_resume.py``):
    any file that is not a torch zip is read as one, and one that lacks a
    key the JAX driver reads is refused, naming the key.
    ``--unroll-fixations`` tunes only the JAX scan: the driver accepts it and
    trains (its losses against ``0`` in ``test_torch_port_utils.py``)."""
    flag = [str(tmp_path / f) if f.endswith(".msgpack") else f for f in flag]
    (tmp_path / "jax.msgpack").write_bytes(b"\x81\xa5epoch\x01")   # {"epoch": 1}
    argv = DRIVER_ARGS + ["--device", "cpu", "--checkpoint-dir", str(tmp_path)] + flag
    if flag[0] == "--resume":
        with pytest.raises(ValueError, match="no 'step', 'state_dict'"):
            driver.main(argv)
    else:
        assert driver.main(argv).step == 2 * F


def test_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(DRIVER_ARGS + ["--epochs", "1"])


def test_train_step_draws_from_generator():
    """Without given draws the step samples its own from the generator:
    the same seed gives the same losses."""
    def run(seed):
        model = SimCLRModule(arch="ResNet10", generator=torch.Generator().manual_seed(0))
        st = ttrain.TrainState(model, toptim.get_optimizer("sgd", model.parameters()),
                               tsched.simclr_learning_rate(*LR_ARGS))
        images = torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(5))
        step = ttrain.make_train_step(tr.RetinaConfig(**GEOM), F, T)
        return step(st, images, torch.Generator().manual_seed(seed))

    a, b = run(1), run(1)
    assert torch.equal(a, b) and torch.isfinite(a).all()
