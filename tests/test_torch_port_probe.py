"""The PyTorch port's linear probe against the JAX package's.

Same inputs on both sides: numpy-seeded images and weights (the JAX trees'
shapes from ``jax.eval_shape``, values from numpy, carried into the port by
``from_jax_variables`` and ``from_jax_probe_variables``); the fixations a
JAX step draws from its key are recomputed and handed to the port. Small
sizes: ResNet10 encoder, canvas 64, B=4, F=2, 10 classes, float32. Then the
driver chain SimCLR → probe on the CPU.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu import config as jconfig
from multimodal_active_ai_tpu.models import LogisticRegression as JaxProbe
from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import eval_probe as jprobe
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train import schedule as jsched
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu.utils import checkpoint as jckpt
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import representation_evaluation as driver
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import eval_probe, optimizers, schedule
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, CLASSES = 4, 2, 10
FEAT = 512 * 16 * F
# Adam at lr 1e-3 (no warmup, linear scaling to batch 4: lr(0) = 1.5625e-5)
LR_ARGS = (1e-3, B, 16, B, 0, 5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _numpy_tree(tree, rng, path=()):
    """Seeded numpy values in the shapes of a flax variable tree: conv
    kernels ~N(0, 2/fan_in), Dense kernels ~N(0, 1/fan_in), BatchNorm scales
    near 1, small biases, running means ~N(0, 1), running variances U[1, 4]."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        value = rng.normal(0, np.sqrt((2.0 if len(shape) == 4 else 1.0)
                                      / np.prod(shape[:-1])), shape)
    elif name == "scale":
        value = 1 + rng.normal(0, 0.05, shape)
    elif name == "mean":
        value = rng.normal(0, 1, shape)
    elif name == "var":
        value = rng.uniform(1, 4, shape)
    else:
        value = rng.normal(0, 0.02, shape)
    return value.astype(np.float32)


def _fixations(key):
    """The ``(F·B, 2)`` view-major fixations JAX's ``extract_features``
    draws from ``key``."""
    return _t(jnp.concatenate([jax.random.uniform(k, (B, 2))
                               for k in jax.random.split(key, F)]))


@pytest.fixture(scope="module")
def jax_run():
    """JAX features, two probe train steps (Adam) and an eval step."""
    encoder = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    probe = JaxProbe(num_classes=CLASSES)
    x = jnp.ones((2, 30, 30, 12))
    rng = np.random.default_rng(0)
    enc = _numpy_tree(jax.eval_shape(lambda k: encoder.init(k, x, train=False),
                                     jax.random.PRNGKey(0)), rng)
    head = _numpy_tree(jax.eval_shape(probe.init, jax.random.PRNGKey(0),
                                      jnp.ones((2, FEAT))), rng)["params"]
    images = np.random.default_rng(1).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    labels = np.array([1, 9, 4, 4])
    rcfg = jr.RetinaConfig(**GEOM)
    keys = [jax.random.PRNGKey(s) for s in (20, 21, 22, 23)]
    feats = jax.jit(jprobe.extract_features, static_argnums=(0, 4, 5))(
        encoder, enc, jnp.asarray(images), keys[0], rcfg, F)
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    state = JaxState.create(apply_fn=probe.apply, params=head, batch_stats={},
                            tx=joptim.get_optimizer("adam", jsched.simclr_learning_rate(*LR_ARGS)))
    step = jprobe.make_probe_train_step(encoder, probe, mesh, rcfg, F)
    losses = []
    for key in keys[1:3]:
        state, m = step(state, enc, jnp.asarray(images), jnp.asarray(labels), key)
        losses.append(float(m["loss"]))
    ev = jprobe.make_probe_eval_step(encoder, probe, mesh, rcfg, F)(
        state, enc, jnp.asarray(images), jnp.asarray(labels), keys[3])
    return dict(enc=enc, head=head, images=images, labels=labels, keys=keys,
                feats=np.asarray(feats), logits=np.asarray(probe.apply({"params": head}, feats)),
                losses=losses, params=jax.device_get(state.params), eval=jax.device_get(ev))


def _port_encoder(enc):
    model = SimCLRModule(arch="ResNet10")
    model.load_state_dict(tckpt.from_jax_variables(enc["params"], enc["batch_stats"]))
    return model


@pytest.fixture(scope="module")
def port_run(jax_run):
    encoder = _port_encoder(jax_run["enc"])
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    probe = LogisticRegression(FEAT, CLASSES)
    probe.load_state_dict(tckpt.from_jax_probe_variables(jax_run["head"], F))
    cfg = tr.RetinaConfig(**GEOM)
    images, labels = _t(jax_run["images"]), _t(jax_run["labels"])
    keys = jax_run["keys"]
    feats = eval_probe.extract_features(encoder, images, cfg, F, fix_yx=_fixations(keys[0]))
    with torch.no_grad():
        logits = probe(feats)
    state = TrainState(probe, optimizers.get_optimizer("adam", probe.parameters()),
                       schedule.simclr_learning_rate(*LR_ARGS))
    step = eval_probe.make_probe_train_step(cfg, F)
    ms = [step(state, encoder, images, labels, fix_yx=_fixations(k)) for k in keys[1:3]]
    ev = eval_probe.make_probe_eval_step(cfg, F)(state, encoder, images, labels,
                                                 fix_yx=_fixations(keys[3]))
    return dict(encoder=encoder, before=before, feats=feats, logits=logits, state=state,
                losses=[float(m["loss"]) for m in ms], eval=ev)


# ---------------------------------------------------------------------------
# the config, the labeled retina and the features


def _flags(cls):
    """Each field's flag names, default, choices and action."""
    return {f.name: (f.metadata.get("names"), f.default, f.metadata.get("choices"),
                     f.metadata.get("action")) for f in dataclasses.fields(cls)}


def test_eval_config_matches_jax():
    """The probe driver's flags are the JAX driver's, names and defaults,
    plus ``--device``."""
    port = _flags(tconfig.EvalConfig)
    assert port.pop("device")[1] == "cuda"
    assert port == _flags(jconfig.EvalConfig)
    cfg = tconfig.parse_into(tconfig.EvalConfig, ["ck.pth.tar", "--dataset", "synthetic",
                                                  "-e", "--no-bf16", "-f", "3"])
    assert (cfg.model, cfg.data, cfg.evaluate, cfg.bf16, cfg.num_fixations) == (
        "ck.pth.tar", None, True, False, 3)


def test_sample_labeled_params_matches_jax():
    """Given a fixation: the JAX parameters field for field; drawn: ~U[0,1)²
    from the generator, deterministic, the rest neutral."""
    key = jax.random.PRNGKey(4)
    ref = jr.sample_labeled_params(key, B, 64)
    got = tr.sample_labeled_params(None, B, 64, fix_yx=_t(jax.random.uniform(key, (B, 2))))
    for name, a, b in zip(tr.AugParams._fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    drawn = tr.sample_labeled_params(torch.Generator().manual_seed(1), 6, 64)
    again = tr.sample_labeled_params(torch.Generator().manual_seed(1), 6, 64)
    assert torch.equal(drawn.fix_yx, again.fix_yx) and drawn.fix_yx.shape == (6, 2)
    assert ((drawn.fix_yx >= 0) & (drawn.fix_yx < 1)).all()
    neutral = tr.neutral_params(6, 64)
    for name, a, b in zip(tr.AugParams._fields[1:], drawn[1:], neutral[1:]):
        assert torch.equal(a, b), name


def test_extract_features_matches_jax(jax_run, port_run):
    """``(B, F·C·16)``, fixation-major, each block the C-major flatten of
    the JAX NHWC block. Float32 ResNet10 in eval mode on glimpses that agree
    but for a rare bf16 rounding step of a y weight (see the retina tests);
    normwise 1e-4 (measured 1.0e-6)."""
    got, ref = port_run["feats"], jax_run["feats"]
    assert got.shape == (B, FEAT) and got.dtype == torch.float32
    blocks = ref.reshape(B, F, 4, 4, 512).transpose(0, 1, 4, 2, 3).reshape(B, FEAT)
    assert _normwise(got, blocks) <= 1e-4
    # the encoder ran in eval mode: its running statistics did not move
    assert not port_run["encoder"].training
    now = port_run["encoder"].state_dict()
    assert all(torch.equal(now[k], v) for k, v in port_run["before"].items())


def test_extract_features_is_one_sampler_call():
    """All F fixations in one glimpse sampler call (the CPU runs its plain
    version; on the card this is one B1 launch)."""
    calls = []
    kept = tr.glimpse_sample

    def counting(*args):
        calls.append(args[1].shape)
        return kept(*args)

    tr.glimpse_sample = counting
    try:
        encoder = SimCLRModule(arch="ResNet10", generator=torch.Generator().manual_seed(0))
        images = torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(2))
        tgs.glimpse_sample.launches = 0
        out = eval_probe.extract_features(encoder, images, tr.RetinaConfig(**GEOM), 3,
                                          torch.Generator().manual_seed(3))
    finally:
        tr.glimpse_sample = kept
    assert calls == [(3 * B, 4, 900)] and tgs.glimpse_sample.launches == 0
    assert out.shape == (B, 3 * 512 * 16) and torch.isfinite(out).all()


def test_probe_logits_match_jax(jax_run, port_run):
    """The carried probe on the port's features against the JAX probe on
    the JAX features: a wrong block permutation would miss by O(1);
    normwise 1e-4 (measured 1.3e-6)."""
    assert _normwise(port_run["logits"], jax_run["logits"]) <= 1e-4


# ---------------------------------------------------------------------------
# train and eval steps


def test_probe_train_steps_match_jax(jax_run, port_run):
    """Two Adam steps: losses to 1e-4 relative (measured 1.4e-7); Adam
    moves each weight by about lr whatever its gradient, so every weight
    agrees to 2·lr·steps and the median one to 1% of lr (measured: max
    3.2e-4·lr, median 0)."""
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=1e-4)
    assert port_run["state"].step == 2
    lr = schedule.simclr_learning_rate(*LR_ARGS)(0)
    got = port_run["state"].model.state_dict()
    want = tckpt.from_jax_probe_variables(jax_run["params"], F)
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        assert d.max() <= 2 * lr * 2 * (1 + 1e-3), (k, d.max())
        assert np.median(d) <= 1e-2 * lr, k


def test_probe_eval_step_matches_jax(jax_run, port_run):
    ev, ref = port_run["eval"], jax_run["eval"]
    np.testing.assert_allclose(float(ev["loss"]), float(ref["loss"]), rtol=1e-4)
    assert float(ev["top1"]) == pytest.approx(float(ref["top1"]))
    assert float(ev["top5"]) == pytest.approx(float(ref["top5"]))


def test_from_jax_probe_variables_matches_the_exporter(jax_run):
    got = tckpt.from_jax_probe_variables(jax_run["head"], F)
    want = jckpt.export_torch_classifier_state_dict(jax_run["head"], F)
    assert sorted(got) == sorted(want) == ["linear.bias", "linear.weight"]
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    LogisticRegression(FEAT, CLASSES).load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="blocks"):
        tckpt.from_jax_probe_variables(jax_run["head"], 3)


# ---------------------------------------------------------------------------
# the driver chain on the CPU: SimCLR → probe, resume, -e, export


SIMCLR_ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", str(B),
               "--canvas-size", "64", "-f", "2", "-t", "--num-examples", "8", "-p", "1",
               "--epochs", "1", "--device", "cpu"]
PROBE_ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", str(B),
              "--canvas-size", "64", "-f", str(F), "-t", "--num-examples", "8", "-p", "1",
              "--epochs", "1", "--device", "cpu", "--num-classes", str(CLASSES),
              "--lr", "1e-3"]


@pytest.fixture(scope="module")
def simclr_checkpoint(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("simclr"))
    simclr_driver.main(SIMCLR_ARGS + ["--checkpoint-dir", ck])
    return os.path.join(ck, "checkpoint.pth.tar")


def test_driver_chain_trains_resumes_and_exports_on_cpu(simclr_checkpoint, jax_run, tmp_path,
                                                        capsys):
    """The probe driver from the port's SimCLR checkpoint: the encoder is
    its ``f`` and stays as loaded, the losses are finite, the checkpoint
    has the reference's four keys, a resume restores every tensor, and the
    JAX package's importer reads the export back into the same weights."""
    ck, export = str(tmp_path), os.path.join(tmp_path, "probe_ref.pth.tar")
    tgs.glimpse_sample.launches = 0
    state = driver.main([simclr_checkpoint] + PROBE_ARGS + ["--checkpoint-dir", ck,
                                                            "--export-torch", export])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"Loss (\S+) ", out)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "=> loaded pretrained model" in out and "##Top-5" in out and "Epoch: [0][1/2]" in out
    assert tgs.glimpse_sample.launches == 0 and state.step == 2
    payload = tckpt.load_checkpoint(os.path.join(ck, "classifier_checkpoint.pth.tar"))
    assert sorted(payload) == ["best_prec1", "epoch", "optimizer", "state_dict"]
    assert payload["epoch"] == 1
    assert all(torch.isfinite(v).all() for v in payload["state_dict"].values())

    resumed = driver.main([simclr_checkpoint] + PROBE_ARGS + [
        "--checkpoint-dir", ck, "--resume", os.path.join(ck, "classifier_checkpoint.pth.tar")])
    assert "=> resumed classifier" in capsys.readouterr().out and resumed.step == 2
    now = resumed.model.state_dict()
    assert all(torch.equal(now[k], v) for k, v in payload["state_dict"].items())
    opt_now = resumed.optimizer.state_dict()["state"]
    for i, st in payload["optimizer"]["state"].items():
        assert all(torch.equal(opt_now[i][k], v) for k, v in st.items())

    exported = torch.load(export, weights_only=True)
    back = jckpt.import_torch_classifier_state_dict(exported["state_dict"], jax_run["head"], F)
    back = tckpt.from_jax_probe_variables(back, F)
    assert all(torch.equal(back[k], now[k]) for k in now)


def test_driver_evaluate_only(simclr_checkpoint, tmp_path, capsys):
    prec1, prec5 = driver.main([simclr_checkpoint] + PROBE_ARGS + ["-e", "--checkpoint-dir",
                                                                   str(tmp_path)])
    assert "##Top-1" in capsys.readouterr().out and 0 <= prec1 <= prec5 <= 100


@pytest.mark.parametrize("flag", [["--resume", "jax.msgpack"]])
def test_driver_refuses_unported_flags(flag, tmp_path):
    """``--multislice`` is ported (``test_torch_port_distributed_drivers.py``),
    and so is a resume from a JAX checkpoint (``test_torch_port_resume.py``):
    any file that is not a torch zip is read as one, and one that lacks a
    key the JAX driver reads is refused, naming the key."""
    flag = [str(tmp_path / f) if f.endswith(".msgpack") else f for f in flag]
    (tmp_path / "jax.msgpack").write_bytes(b"\x81\xa5epoch\x01")   # {"epoch": 1}
    with pytest.raises(ValueError, match="no 'state_dict'"):
        driver.main(["x"] + PROBE_ARGS + flag)


def test_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    args = list(PROBE_ARGS)
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["x"] + args)
