"""The port's SimCLR train step with fused BatchNorm statistics against the
JAX package's, and the driver with ``--stat-fusion``.

The whole train step runs on both sides with ResNet-50, ``norm_kind=
'bn_fused'`` (``stat_sums``) and ``stat_fusion='pallas'``
(``conv1x1_stats``), b=2, F=1, canvas 64, float32, from equal weights,
images and random draws. The JAX side runs its Pallas kernels in interpret
mode on the CPU; the port takes its plain versions. With 2 images the
layer2 projections see 2·15·15 = 450 rows, not a multiple of 8, so both
sides also route those through the gram form. Then the driver end to end on
the CPU with ``--stat-fusion pallas``, resumed under the same and under
other ``--stat-fusion`` values.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
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
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as tcs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.ops import stat_sums as tss
from multimodal_active_ai_tpu_torch.train import optimizers as toptim
from multimodal_active_ai_tpu_torch.train import schedule as tsched
from multimodal_active_ai_tpu_torch.train import simclr_train as ttrain
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, T = 2, 1, 0.05
LR_ARGS = (0.01, B, 16, B, 0, 5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _views(keys, n_views):
    """The per-view AugParams and noise that ``jax.random`` gives a step's
    view keys ``(kp, kn)``, as the port's tensors."""
    cfg = jr.RetinaConfig(**GEOM)
    g, ch = cfg.glimpse_size, cfg.num_channels
    params, noise = [], []
    for kp, kn in keys[:n_views]:
        p = jr.sample_unlabeled_params(kp, B, 64, cfg)
        params.append(tr.AugParams(*[_t(x) for x in p]))
        nz = jax.vmap(lambda k: jax.random.normal(k, (g, g, ch)))(jax.random.split(kn, B))
        noise.append(_t(nz))
    return params, noise


@pytest.fixture(scope="module")
def fused_step():
    """One JAX train step of the fused ResNet-50 and the port's, from equal
    weights, images and draws."""
    model = JaxSimCLR(arch="ResNet50", axis_name=None, norm_kind="bn_fused",
                      stat_fusion="pallas")
    tx = joptim.get_optimizer("adam", jsched.simclr_learning_rate(*LR_ARGS))
    state0 = jtrain.create_train_state(model, tx, jax.random.PRNGKey(0),
                                       jnp.ones((2, 30, 30, 12)))
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    images = np.random.default_rng(1).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(2)
    step = jtrain.make_train_step(model, mesh, jr.RetinaConfig(**GEOM), F, T, donate=False)
    state1, metrics = step(state0, jnp.asarray(images), key)

    sd0 = tckpt.from_jax_variables(jax.device_get(state0.params),
                                   jax.device_get(state0.batch_stats))
    params, noise = _views(jax.random.split(key, 2 * (F + 1)).reshape(F + 1, 2, 2), F + 1)
    launches = tss.stat_sums.launches, tcs.conv1x1_stats.launches

    def port_step(**kinds):
        port = SimCLRModule(arch="ResNet50", **kinds)
        port.load_state_dict(sd0)
        tstate = ttrain.TrainState(port, toptim.get_optimizer("adam", port.parameters()),
                                   tsched.simclr_learning_rate(*LR_ARGS))
        losses = ttrain.make_train_step(tr.RetinaConfig(**GEOM), F, T)(
            tstate, _t(images), params=params, noise=noise)
        return losses, tstate

    losses, tstate = port_step(norm_kind="bn_fused", stat_fusion="pallas")
    launched = (tss.stat_sums.launches - launches[0],
                tcs.conv1x1_stats.launches - launches[1])
    unfused_losses, unfused_state = port_step(norm_kind="bn")
    return dict(jax_losses=np.asarray(metrics["losses"]), losses=losses, state=tstate,
                unfused_losses=unfused_losses, unfused_state=unfused_state,
                jax_sd=tckpt.from_jax_variables(jax.device_get(state1.params),
                                                jax.device_get(state1.batch_stats)),
                lr=tsched.simclr_learning_rate(*LR_ARGS)(0), launched=launched)


def test_fused_train_step_losses_match_jax(fused_step):
    """The loss of fixation 1 depends on the two views' forwards only. The
    two sides' glimpses differ where a sampling coordinate 1 ulp apart
    moves a bf16 y weight across a rounding step (a few elements by up to
    ~2, see tests/test_torch_port_retina.py); 53 BatchNorm layers over
    2 images and NT-Xent at T=0.05 over 4 projections amplify that. The
    same harness with the unfused ResNet-50 (norm 'bn', no stat fusion)
    measured 0.7% relative; this step 0.9%. On identical glimpses the
    fused forward agrees with the JAX one to 2e-4 of its largest output
    (as the unfused does), and with the port's unfused step to float
    rounding (next test)."""
    losses = fused_step["losses"]
    assert losses.shape == (F,) and torch.isfinite(losses).all()
    np.testing.assert_allclose(losses.numpy(), fused_step["jax_losses"], rtol=2e-2)
    assert fused_step["state"].step == F
    # CPU tensors take the plain versions: no kernel launched
    assert fused_step["launched"] == (0, 0)


def test_fused_train_step_params_and_statistics_match_jax(fused_step):
    """After one Adam update: Adam's first step moves each weight by about
    ``lr`` whatever its gradient's size, so a weight whose gradient is
    within rounding of zero may step either way. Every weight agrees to
    ``2·lr``, the median to 1% of ``lr``, and at most 5% differ by more
    than ``lr/10`` (measured: 4.2%; the unfused ResNet-50 in the same
    harness: 3.1%). The running statistics of the 1 + F train-mode
    forwards, B2's and B3's alike, carry the glimpse differences of the
    losses: they agree to 1% of each tensor's largest value (measured:
    0.52%; unfused: 0.80%)."""
    got = fused_step["state"].model.state_dict()
    want = fused_step["jax_sd"]
    lr = fused_step["lr"]
    assert sorted(got) == sorted(want)
    diffs = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].numpy() - w.numpy())
        if k.endswith(("running_mean", "running_var")):
            assert d.max() <= 1e-2 * np.abs(w.numpy()).max(), k
            continue
        assert d.max() <= 2 * lr * F * (1 + 1e-3), (k, d.max())
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.median(diffs) <= 1e-2 * lr
    assert (diffs > 0.1 * lr).mean() <= 0.05
    # every norm layer saw the 1 + F train-mode forwards, fused or not
    for k in ("f.bn1", "f.layer1.0.bn1", "f.layer1.0.bn2", "f.layer4.0.downsample.1"):
        assert int(got[k + ".num_batches_tracked"]) == 1 + F, k


def test_fused_train_step_matches_the_unfused_port_step(fused_step):
    """The same step without fusion (norm 'bn', separate ``.mean()``
    statistics), from the same weights and glimpses: the statistics are
    the same sums taken in another order, so losses agree to 1e-4
    relative, running statistics to 1e-4 of each tensor's largest value,
    and weights as in the JAX comparison (one Adam step, about ``lr``
    each)."""
    np.testing.assert_allclose(fused_step["losses"].numpy(),
                               fused_step["unfused_losses"].numpy(), rtol=1e-4)
    got = fused_step["state"].model.state_dict()
    want = fused_step["unfused_state"].model.state_dict()
    assert sorted(got) == sorted(want)
    lr = fused_step["lr"]
    diffs = []
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        if k.endswith("num_batches_tracked"):
            assert d.max() == 0, k
        elif k.endswith(("running_mean", "running_var")):
            assert d.max() <= 1e-4 * w.abs().max(), k
        else:
            assert d.max() <= 2 * lr * F * (1 + 1e-3), k
            diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.median()) <= 1e-3 * lr
    assert float((diffs > 0.1 * lr).double().mean()) <= 0.01


# ---------------------------------------------------------------------------
# the driver with --stat-fusion on the CPU

DRIVER_ARGS = ["--dataset", "synthetic", "--arch", "ResNet50", "-b", str(B),
               "--canvas-size", "64", "-f", "1", "-t", "--num-examples", "4",
               "-p", "1", "--no-bf16", "--device", "cpu"]


@pytest.fixture(scope="module")
def pallas_run(tmp_path_factory):
    """One epoch of the driver with ``--stat-fusion pallas``."""
    ck = str(tmp_path_factory.mktemp("stat_fusion_ckpt"))
    state = driver.main(DRIVER_ARGS + ["--stat-fusion", "pallas", "--epochs", "1",
                                       "--checkpoint-dir", ck])
    return state, os.path.join(ck, "checkpoint.pth.tar")


def test_driver_with_stat_fusion_pallas_trains_and_checkpoints(pallas_run):
    state, ck = pallas_run
    model = state.model
    assert model.f.layer1[0].stat_fusion == "pallas"
    assert state.step == 2 * 1                # 2 batches of 2 examples, F = 1
    payload = tckpt.load_checkpoint(ck)
    assert payload["epoch"] == 1 and payload["step"] == state.step
    assert np.isfinite(payload["loss_history"]).all()
    # the reference layout, as without stat fusion
    assert sorted(payload["state_dict"]) == sorted(SimCLRModule("ResNet50").state_dict())


@pytest.mark.parametrize("fusion", ["pallas", "gram", ""])
def test_driver_resumes_under_any_stat_fusion(pallas_run, tmp_path, capsys, fusion):
    """The port's checkpoints have one layout: a ``--stat-fusion pallas``
    checkpoint resumes with its optimizer state under the same value, the
    gram form and no fusion, and trains on."""
    state, ck = pallas_run
    payload = tckpt.load_checkpoint(ck)
    flags = ["--stat-fusion", fusion] if fusion else []
    resumed = driver.main(DRIVER_ARGS + flags + ["--epochs", "2", "--resume", ck,
                                                 "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "=> loaded checkpoint" in out and "Epoch: [1][0/2]" in out
    assert resumed.step == payload["step"] + 2
    assert resumed.model.f.layer2[0].stat_fusion == (fusion or None)
    assert len(resumed.optimizer.state) == len(payload["optimizer"]["state"])
    again = tckpt.load_checkpoint(os.path.join(str(tmp_path), "checkpoint.pth.tar"))
    assert again["epoch"] == 2 and np.isfinite(again["loss_history"]).all()
