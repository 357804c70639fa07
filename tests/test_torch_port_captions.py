"""The PyTorch port's caption probe against the JAX package's.

Same inputs on both sides: numpy-seeded images and weights (the JAX trees'
shapes from ``jax.eval_shape``, values from numpy, carried into the port by
``from_jax_variables`` and ``from_jax_caption_variables``), the fixations a
JAX step draws from its key recomputed and handed to the port, and the
hashed template captions. Small sizes: ResNet10 encoder, canvas 64, B=4,
F=2, a text tower of vocab 97, d 32, 2 heads, 2 layers, FFN 64, L 8,
dropout 0 (flax broadcasts its attention-dropout mask and torch does not).
Then the driver on the CPU: from a JAX-written SimCLR msgpack, its resume,
and the resume from a JAX caption checkpoint with a vocabulary.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coco_captions_probe import CaptionProbeConfig as JaxCaptionConfig
from multimodal_active_ai_tpu.models import MLP as JaxMLP
from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.models import text as jtext
from multimodal_active_ai_tpu.objectives.ntxent import contrastive_loss as jloss
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import caption_probe as jcap
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu.utils import checkpoint as jckpt
from multimodal_active_ai_tpu_torch import coco_captions_probe as driver
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import TextEncoder
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs
from multimodal_active_ai_tpu_torch.ops import retina as tr
from multimodal_active_ai_tpu_torch.train import caption_probe, optimizers
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F = 4, 2
FEAT = 512 * 16 * F
TEXT = dict(vocab_size=97, d_model=32, nhead=2, num_layers=2, dim_feedforward=64, out_dim=128)
MAX_LEN, LR, TEMP = 8, 1e-4, 0.05


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _numpy_tree(tree, rng, path=()):
    """Seeded numpy values in the shapes of a flax variable tree (as the
    probe's port test makes them): conv kernels ~N(0, 2/fan_in), Dense
    kernels ~N(0, 1/fan_in), BatchNorm scales near 1, running means ~N(0,
    1), variances U[1, 4], embeddings ~N(0, 1/d), small biases."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        # attention's q/k/v kernels are (d_in, heads, head_dim), its out (heads, head_dim, d)
        fan_in = shape[0] if len(shape) == 3 and path[-2] != "out" else np.prod(shape[:-1])
        value = rng.normal(0, np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in), shape)
    elif name == "embedding":
        value = rng.normal(0, np.sqrt(1.0 / shape[1]), shape)
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


def _tokens(labels, vocab_size=TEXT["vocab_size"], max_len=MAX_LEN):
    return np.asarray([jtext.tokenize(f"a synthetic picture of class {int(l)}", vocab_size,
                                      max_len)[0] for l in labels], np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """JAX variables, one caption train step (its loss, gradients and the
    parameters after the Adam update) and an eval step."""
    encoder = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    head = JaxMLP(hidden_dim=1024, output_dim=128)
    text = jtext.TextEncoder(**TEXT, dropout=0.0)
    rng = np.random.default_rng(0)
    enc = _numpy_tree(jax.eval_shape(lambda k: encoder.init(k, jnp.ones((2, 30, 30, 12)),
                                                            train=False),
                                     jax.random.PRNGKey(0)), rng)
    params = {"image_head": _numpy_tree(jax.eval_shape(head.init, jax.random.PRNGKey(0),
                                                       jnp.ones((2, FEAT))), rng)["params"],
              "text": _numpy_tree(jax.eval_shape(text.init, jax.random.PRNGKey(0),
                                                 jnp.zeros((2, MAX_LEN), jnp.int32)),
                                  rng)["params"]}
    images = np.random.default_rng(1).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    labels = np.array([3, 17, 3, 250])
    tokens = _tokens(labels)
    rcfg = jr.RetinaConfig(**GEOM)
    train_key, eval_key = jax.random.PRNGKey(31), jax.random.PRNGKey(32)

    def loss_fn(p):
        img = jcap.image_tower(encoder, enc, p["image_head"], head, jnp.asarray(images),
                               jax.random.split(train_key)[0], rcfg, F)
        txt = text.apply({"params": p["text"]}, jnp.asarray(tokens), train=True,
                         rngs={"dropout": jax.random.split(train_key)[1]})
        return jloss(img, txt, temperature=TEMP, torch_gather_semantics=False)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    state = JaxState.create(apply_fn=None, params=params, batch_stats={},
                            tx=joptim.get_optimizer("adam", LR))
    step = jcap.make_caption_probe_train_step(encoder, head, text, mesh, rcfg, F, TEMP)
    state, m = step(state, enc, jnp.asarray(images), jnp.asarray(tokens), train_key)
    ev = jcap.make_caption_probe_eval_step(encoder, head, text, mesh, rcfg, F, TEMP)(
        state, enc, jnp.asarray(images), jnp.asarray(tokens), eval_key)
    return dict(enc=enc, params=params, images=images, tokens=tokens,
                keys=(train_key, eval_key), loss=float(m["loss"]), grads=jax.device_get(grads),
                after=jax.device_get(state.params), eval=jax.device_get(ev))


@pytest.fixture(scope="module")
def port_run(jax_run):
    encoder = SimCLRModule(arch="ResNet10")
    encoder.load_state_dict(tckpt.from_jax_variables(jax_run["enc"]["params"],
                                                     jax_run["enc"]["batch_stats"]))
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    towers = caption_probe.CaptionTowers(FEAT, TextEncoder(**TEXT, dropout=0.0))
    towers.load_state_dict(tckpt.from_jax_caption_variables(jax_run["params"], F), strict=True)
    state = TrainState(towers, optimizers.get_optimizer("adam", towers.parameters()),
                       lambda _: LR)
    cfg = tr.RetinaConfig(**GEOM)
    images, tokens = _t(jax_run["images"]), _t(jax_run["tokens"]).long()
    train_key, eval_key = jax_run["keys"]
    m = caption_probe.make_caption_probe_train_step(cfg, F, TEMP)(
        state, encoder, images, tokens, fix_yx=_fixations(jax.random.split(train_key)[0]))
    grads = {n: p.grad.clone() for n, p in towers.named_parameters()}
    ev = caption_probe.make_caption_probe_eval_step(cfg, F, TEMP)(
        state, encoder, images, tokens, fix_yx=_fixations(eval_key))
    return dict(encoder=encoder, before=before, state=state, loss=float(m["loss"]),
                grads=grads, eval=ev)


# ---------------------------------------------------------------------------
# the config and the steps


def _flags(cls):
    return {f.name: (f.metadata.get("names"), f.default, f.metadata.get("choices"),
                     f.metadata.get("action")) for f in dataclasses.fields(cls)}


def test_caption_config_matches_jax():
    """The caption driver's flags are the JAX driver's, names and
    defaults, plus ``--device``; no ``--bf16`` (the encoder is float32)."""
    port = _flags(tconfig.CaptionProbeConfig)
    assert port.pop("device")[1] == "cuda"
    assert port == _flags(JaxCaptionConfig) and "bf16" not in port


def test_caption_train_step_loss_matches_jax(jax_run, port_run):
    """Symmetric InfoNCE at temperature 0.05 on the carried towers:
    1e-4 relative (measured 0: the same float32 value)."""
    np.testing.assert_allclose(port_run["loss"], jax_run["loss"], rtol=1e-4)
    assert port_run["state"].step == 1


def test_caption_train_step_gradients_match_jax(jax_run, port_run):
    """``torch_gather_semantics=False``: both towers get gradient, every
    tensor of each non-zero, and each matches the JAX gradient carried
    through the same map (the image head's per-fixation permutation
    included) to normwise 1e-4 (measured at most 1.1e-6)."""
    want = tckpt.from_jax_caption_variables(jax_run["grads"], F)
    got = port_run["grads"]
    assert sorted(got) == sorted(want)
    for tower in ("image_head.", "text."):
        names = [n for n in got if n.startswith(tower)]
        assert names and all(got[n].abs().max() > 0 for n in names), tower
    for n, w in want.items():
        assert _normwise(got[n], w) <= 1e-4, n


def test_caption_train_step_update_matches_jax(jax_run, port_run):
    """One Adam update of both towers at the constant lr: Adam moves each
    weight by about lr whatever its gradient, so every weight agrees to
    2·lr and the median one to 1% of lr (the probe test's criterion;
    measured: max 1.58·lr where a near-zero gradient's sign differs, median
    0), and every tensor moved."""
    got = port_run["state"].model.state_dict()
    want = tckpt.from_jax_caption_variables(jax_run["after"], F)
    before = tckpt.from_jax_caption_variables(jax_run["params"], F)
    for k, w in want.items():
        d = np.abs(got[k].numpy() - w.numpy())
        assert d.max() <= 2 * LR * (1 + 1e-3), (k, d.max())
        assert np.median(d) <= 1e-2 * LR, k
        assert not torch.equal(got[k], before[k]), k


def test_caption_eval_step_matches_jax(jax_run, port_run):
    """The loss to 1e-4 relative (measured 3.0e-6) and the four retrieval
    metrics exactly;
    the frozen encoder ran in eval mode and did not move."""
    ev, ref = port_run["eval"], jax_run["eval"]
    np.testing.assert_allclose(float(ev["loss"]), float(ref["loss"]), rtol=1e-4)
    for k in ("i2t_top1", "i2t_top5", "t2i_top1", "t2i_top5"):
        assert float(ev[k]) == float(ref[k]), k
    now = port_run["encoder"].state_dict()
    assert not port_run["encoder"].training
    assert all(torch.equal(now[k], v) for k, v in port_run["before"].items())


def test_from_jax_caption_variables_permutes_the_head_per_fixation(jax_run):
    """The head's ``Dense_0`` rows follow the NHWC flatten of each
    fixation's block in JAX and the C-major one in the port: carried
    weights on C-major features give the JAX head on NHWC features."""
    sd = tckpt.from_jax_caption_variables(jax_run["params"], F)
    feats = np.random.default_rng(5).normal(size=(B, F, 4, 4, 512)).astype(np.float32)
    ref = np.asarray(JaxMLP(1024, 128).apply({"params": jax_run["params"]["image_head"]},
                                             feats.reshape(B, FEAT)))
    head = caption_probe.CaptionTowers(FEAT, TextEncoder(**TEXT)).image_head
    head.load_state_dict({k[len("image_head."):]: v for k, v in sd.items()
                          if k.startswith("image_head.")})
    got = head(torch.from_numpy(feats.transpose(0, 1, 4, 2, 3).reshape(B, FEAT)))
    assert _normwise(got, ref) <= 1e-5
    with pytest.raises(ValueError, match="blocks"):
        tckpt.from_jax_caption_variables(jax_run["params"], 3)


# ---------------------------------------------------------------------------
# the driver on the CPU


ARGS = ["--dataset", "synthetic", "-a", "ResNet10", "-b", str(B), "--canvas-size", "64",
        "-f", str(F), "-t", "--epochs", "1", "--device", "cpu", "-p", "4"]


@pytest.fixture(scope="module")
def jax_simclr_msgpack(jax_run, tmp_path_factory):
    """A SimCLR checkpoint written by the JAX package's own
    ``save_checkpoint`` (its encoder the JAX run's)."""
    path = str(tmp_path_factory.mktemp("jax_simclr") / "checkpoint.msgpack")
    jckpt.save_checkpoint({"epoch": 1, "state_dict": {
        "params": jax_run["enc"]["params"], "batch_stats": jax_run["enc"]["batch_stats"]},
        "best_prec1": 0.0, "loss_history": [1.5]}, False, filename=path)
    return path


def _spy_first_step(monkeypatch):
    """Record the towers' tensors and the step count when the driver's
    first train step is called."""
    seen = {}
    make = caption_probe.make_caption_probe_train_step

    def spy(*args, **kwargs):
        step = make(*args, **kwargs)

        def first(state, *rest, **kw):
            if not seen:
                seen.update(sd={k: v.clone() for k, v in state.model.state_dict().items()},
                            step=state.step, opt=len(state.optimizer.state))
            return step(state, *rest, **kw)
        return first

    monkeypatch.setattr(caption_probe, "make_caption_probe_train_step", spy)
    return seen


def test_driver_trains_and_resumes_on_cpu(jax_simclr_msgpack, jax_run, tmp_path, capsys,
                                          monkeypatch):
    """The driver from a JAX-written SimCLR msgpack: its encoder is that
    encoder and stays frozen, 12 train and 5 eval steps (the CPU runs B1's
    plain version: no launch), finite losses and retrieval lines, the
    checkpoint's keys; then ``--resume`` restores every tensor of both
    towers (Adam fresh, the epochs from 0)."""
    ck = str(tmp_path)
    calls = []
    kept = tr.glimpse_sample
    monkeypatch.setattr(tr, "glimpse_sample", lambda *a: calls.append(1) or kept(*a))
    tgs.glimpse_sample.launches = 0
    state, vocab = driver.main([jax_simclr_msgpack] + ARGS + ["--checkpoint-dir", ck])
    out = capsys.readouterr().out
    assert "=> loaded pretrained model" in out and vocab is None
    assert len(calls) == 12 + 5 and tgs.glimpse_sample.launches == 0 and state.step == 12
    losses = [float(x) for x in re.findall(r"Loss (\S+) ", out)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    top = {k: float(v) for k, v in re.findall(r"##(\S+ Top-\d) (\S+)", out)}
    assert sorted(top) == ["I2T Top-1", "I2T Top-5", "T2I Top-1", "T2I Top-5"]
    assert all(0 <= v <= 1 for v in top.values())
    payload = tckpt.load_checkpoint(os.path.join(ck, "caption_probe_checkpoint.pth.tar"))
    assert sorted(payload) == ["epoch", "state_dict", "vocab_size"]
    assert payload["epoch"] == 1 and payload["vocab_size"] == 32768
    assert sorted(payload["state_dict"]) == sorted(state.model.state_dict())

    seen = _spy_first_step(monkeypatch)
    resumed, _ = driver.main([jax_simclr_msgpack] + ARGS + [
        "--checkpoint-dir", ck, "--resume", os.path.join(ck, "caption_probe_checkpoint.pth.tar")])
    assert "=> resumed caption probe" in capsys.readouterr().out
    assert seen["step"] == 0 and seen["opt"] == 0 and resumed.step == 12
    assert all(torch.equal(seen["sd"][k], v) for k, v in payload["state_dict"].items())


def test_driver_encoder_is_the_jax_checkpoints(jax_simclr_msgpack, jax_run):
    """The caption driver's loader gives the encoder ``f`` that
    ``from_jax_variables`` gives for the same variables (the projector is
    never used downstream)."""
    encoder = SimCLRModule(arch="ResNet10")
    assert driver.load_pretrained_encoder(encoder, jax_simclr_msgpack, torch.device("cpu"))
    want = tckpt.from_jax_variables(jax_run["enc"]["params"], jax_run["enc"]["batch_stats"])
    got = encoder.state_dict()
    enc = [k for k in want if k.startswith("f.")]
    assert len(enc) == len(encoder.f.state_dict()) and all(torch.equal(got[k], want[k])
                                                         for k in enc)


def test_driver_resumes_from_a_jax_caption_checkpoint(jax_simclr_msgpack, tmp_path, capsys):
    """A JAX caption payload (the JAX package's ``save_checkpoint``, with a
    corpus vocabulary) resumes in the port: its towers carried with the
    head permuted per fixation, its vocabulary restored and written again
    into the port's checkpoint, which a second resume reads back."""
    vocab = jtext.Vocabulary.build(["a dog on a log", "naïve café's cat", "a cat"], max_len=32)
    text = jtext.TextEncoder(vocab_size=vocab.size, out_dim=128)
    rng = np.random.default_rng(3)
    params = {"image_head": _numpy_tree(jax.eval_shape(JaxMLP(1024, 128).init,
                                                       jax.random.PRNGKey(0),
                                                       jnp.ones((2, FEAT))), rng)["params"],
              "text": _numpy_tree(jax.eval_shape(text.init, jax.random.PRNGKey(0),
                                                 jnp.zeros((2, 32), jnp.int32)), rng)["params"]}
    path = str(tmp_path / "caption_probe_checkpoint.msgpack")
    jckpt.save_checkpoint({"epoch": 3, "state_dict": params, "vocab_size": vocab.size,
                           "vocab_words_u8": vocab.to_u8()}, False, filename=path)
    ck = str(tmp_path / "port")
    args = [jax_simclr_msgpack] + ARGS + ["--vocab-size", str(vocab.size), "--checkpoint-dir", ck]
    state, got_vocab = driver.main(args + ["--resume", path, "--epochs", "0"])
    out = capsys.readouterr().out
    assert "(epoch 3)" in out and state.step == 0
    assert got_vocab.words == vocab.words and got_vocab.size == vocab.size
    want = tckpt.from_jax_caption_variables(params, F)
    now = state.model.state_dict()
    assert sorted(now) == sorted(want)
    assert all(torch.equal(now[k], v) for k, v in want.items())

    state, _ = driver.main(args + ["--resume", path])
    assert f"##Vocab {vocab.size} OOV-rate" in capsys.readouterr().out
    payload = tckpt.load_checkpoint(os.path.join(ck, "caption_probe_checkpoint.pth.tar"))
    assert payload["vocab_size"] == vocab.size
    assert jtext.Vocabulary.from_u8(payload["vocab_words_u8"].numpy()).words == vocab.words
    _, again = driver.main(args + ["--resume", os.path.join(ck, "caption_probe_checkpoint.pth.tar"),
                                   "--epochs", "0"])
    assert again.words == vocab.words


def test_driver_refuses_another_vocabulary_size(tmp_path):
    """A checkpoint whose text tower was built for 50 entries does not load
    into a run with the default 32768."""
    path = str(tmp_path / "small.pth.tar")
    torch.save({"epoch": 1, "vocab_size": 50, "state_dict": {}}, path)
    with pytest.raises(ValueError, match="50-entry vocabulary"):
        driver.main(ARGS + ["--checkpoint-dir", str(tmp_path), "--resume", path])


@pytest.mark.parametrize("flag", [["--dataset", "mscoco"], ["--dataset", "imagefolder"]])
def test_driver_refuses_unported_flags(flag):
    """The file readers are ported (the driver reads files in
    ``test_torch_port_data_drivers.py``); without a data directory they raise."""
    with pytest.raises(FileNotFoundError, match="no data directory"):
        driver.main(ARGS + flag)


def test_driver_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    args = list(ARGS)
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(args)
