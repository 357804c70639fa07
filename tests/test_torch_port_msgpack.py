"""The port's flax-msgpack reader, and JAX-written SimCLR checkpoints as the
input of the port's downstream drivers.

The reader (``utils/flax_msgpack.py``, pure Python and numpy) must return
the tree ``flax.serialization.msgpack_restore`` returns for bytes the JAX
package writes: a ResNet10 SimCLR payload from its ``save_checkpoint`` with
the optax state, the histories and ``total_time``; bf16 and integer arrays,
numpy scalars, large and negative integers; a chunked array (flax's chunk
limit lowered inside the test only). Then the probe's and DETR's (and so
RLS's) pretrained-encoder loaders, given such a msgpack, must load the
state that ``from_jax_variables`` of the same variables gives, for the
plain Bottleneck-free ResNet10 and for ResNet-50 in its ``stat_fusion``
(``FusedConv1x1BN``) layout and with ``norm_kind='bn_fused'``.
"""

import os
import subprocess
import sys
from collections import OrderedDict

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.utils import checkpoint as jckpt
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
from multimodal_active_ai_tpu_torch import representation_evaluation as probe_driver
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from multimodal_active_ai_tpu_torch.utils import flax_msgpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(tree, rng, path=()):
    """Seeded float32 values in a flax variable tree's shapes (BatchNorm
    variances positive)."""
    if isinstance(tree, dict):
        return {k: _values(v, rng, path + (k,)) for k, v in tree.items()}
    v = rng.standard_normal(tree.shape, dtype=np.float32) * np.float32(0.05)
    return np.abs(v) + np.float32(1) if path[-1] in ("var", "scale") else v


def _jax_variables(arch, **kinds):
    model = JaxSimCLR(arch=arch, axis_name=None, **kinds)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.ones((2, 30, 30, 12)), train=False),
                            jax.random.PRNGKey(0))
    return _values(jax.tree_util.tree_map(lambda x: x, shapes), np.random.default_rng(0))


def _assert_same_tree(got, ref, path="root"):
    """``got`` (the port's reader) is ``ref`` (flax's): the same dict keys in
    the same order, list lengths, leaf types and values; numpy arrays of the
    same dtype, shape and bits; flax's bfloat16 arrays as torch bfloat16
    tensors of the same bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same_tree(g, r, f"{path}[{i}]")
    elif getattr(ref, "dtype", None) is not None and ref.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(ref), path
        bits = got.view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(bits, np.asarray(ref).view(np.uint16)), path
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, path
        assert got.shape == ref.shape and got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        assert got == ref or (got != got and ref != ref), (path, got, ref)


# ---------------------------------------------------------------------------
# the reader against flax


@pytest.fixture(scope="module")
def simclr_payload_file(tmp_path_factory):
    """A ResNet10 SimCLR checkpoint as the JAX driver writes it (its
    ``save_checkpoint``: params, batch_stats, the optax Adam state, the
    histories and ``total_time``)."""
    variables = _jax_variables("ResNet10", norm_kind="bn")
    opt_state = optax.adam(1e-3).init(variables["params"])
    path = str(tmp_path_factory.mktemp("simclr") / "checkpoint.msgpack")
    jckpt.save_checkpoint({
        "epoch": 2, "step": 22, "state_dict": variables, "best_prec1": 12.5,
        "optimizer": opt_state, "loss_history": np.asarray([4.5, 3.25], np.float64),
        "top1_acc_history": np.asarray([1.0, 2.0]), "top5_acc_history": np.asarray([5.0, 9.0]),
        "total_time": {"val": 1.5, "avg": 1.25, "sum": 2.5, "count": 2.0}}, False, filename=path)
    return path, variables


def test_reader_matches_flax_on_a_simclr_checkpoint(simclr_payload_file):
    path, _ = simclr_payload_file
    with open(path, "rb") as f:
        data = f.read()
    ref = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)
    _assert_same_tree(got, ref)
    # optax states arrive as dicts keyed '0', '1', ...; the count a numpy scalar
    assert list(got["optimizer"]) == ["0", "1"] and got["optimizer"]["0"]["count"].dtype == np.int32
    _assert_same_tree(tckpt.load_checkpoint(path), ref)
    assert not tckpt.is_torch_file(path)


def test_reader_matches_flax_on_leaf_types():
    """bf16 (2-D and a scalar) and integer arrays of every width, numpy
    scalars, Python ints at the msgpack width edges, both signs, floats,
    complex, str (unicode, long), bytes, None, bools, nested lists, empty
    containers (the ndarray payload's shape is a tuple packed as an
    array)."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    tree = {
        "bf16": np.asarray(jnp.arange(-6, 6, dtype=jnp.bfloat16).reshape(3, 4) / 3),
        "bf16_scalar": np.asarray(jnp.bfloat16(2.5)),
        **{f"a_{t}": np.arange(-3, 9).astype(t).reshape(2, 2, 3)
           for t in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                     "uint64", "float16", "float32", "float64", "bool")},
        "empty": np.zeros((0, 4), np.float32),
        "scalars": {"f32": np.float32(-1.5), "i64": np.int64(-2**40), "u8": np.uint8(200),
                    "b": np.bool_(True), "f64": np.float64(1e300)},
        "ints": ints, "floats": [0.5, -1e-300, float("inf")], "nan": float("nan"),
        "complex": complex(1.5, -2.0), "str": "ünïcødé 東京 " * 20, "bytes": b"\x00\xff" * 40,
        "none": None, "flags": [True, False], "nested": [[1, [2, 3]], [4.5]],
        "empties": {"dict": {}, "list": [], "str": ""},
        "wide": {str(i): i for i in range(20)}, "long": list(range(70_000)),
        "huge_map": {str(i): -i for i in range(66_000)}, "big_str": "é" * 40_000,
        "big_bytes": bytes(range(256)) * 300,
    }
    data = flax.serialization.msgpack_serialize(tree)
    got = flax_msgpack.msgpack_restore(data)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    assert got["ints"] == ints and got["bf16"].shape == (3, 4)


def test_reader_matches_flax_on_chunked_arrays(monkeypatch):
    """Arrays over flax's chunk limit (lowered to 256 bytes here) are split
    into ``'__msgpack_chunked_array__'`` dicts of flat chunks and joined
    again, at the top of the tree and below, bf16 included."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    tree = {"w": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "deep": {"b": np.asarray(jnp.linspace(-1, 1, 300, dtype=jnp.bfloat16)),
                     "i": np.arange(70, dtype=np.int64), "small": np.ones(3, np.float32)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.msgpack_restore(data)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    assert got["w"].shape == (10, 100) and tuple(got["deep"]["b"].shape) == (300,)


def test_reader_keeps_unknown_ext_codes():
    """Ext codes flax does not write come back with their code and bytes,
    as flax's ``msgpack.ExtType``, from fixext 1/2/4/8/16 and ext 8/16/32."""
    import msgpack

    for n in (1, 2, 4, 8, 16, 3, 300, 70_000):
        data = msgpack.packb([msgpack.ExtType(7, b"z" * n)])
        ref, = flax.serialization.msgpack_restore(data)
        got, = flax_msgpack.msgpack_restore(data)
        assert (got.code, got.data) == (ref.code, ref.data) == (7, b"z" * n)


def test_reader_refuses_malformed_bytes():
    data = flax.serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-1])
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="lead byte"):
        flax_msgpack.msgpack_restore(b"\xc1")


def test_port_imports_no_msgpack_package():
    """Every module of the port and ``chip_smoke.py`` import without the
    ``msgpack`` package (the card's machine has none)."""
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, ".")
import multimodal_active_ai_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
sys.exit(1 if any(m == "msgpack" or m.startswith("msgpack.") for m in sys.modules) else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the pretrained-encoder loaders


def _write_simclr(path, variables):
    jckpt.save_checkpoint({"epoch": 1, "step": 3, "state_dict": variables, "best_prec1": 0.0,
                           "loss_history": np.asarray([2.0])}, False, filename=path)


def _frozen_body_state(arch, simclr_sd):
    model = detr_driver.detr_models.DETR(arch, num_classes=10, hidden_dim=32, nheads=2,
                                         enc_layers=1, dec_layers=1, dim_feedforward=64)
    tckpt.load_simclr_backbone(model.body, simclr_sd)
    return model.body.state_dict()


@pytest.mark.parametrize("arch,kinds", [
    ("ResNet10", dict(norm_kind="bn")),
    ("ResNet50", dict(norm_kind="bn", stat_fusion="pallas")),
    ("ResNet50", dict(norm_kind="bn_fused")),
], ids=["resnet10-bn", "resnet50-stat-fusion-layout", "resnet50-bn_fused"])
def test_loaders_read_a_jax_simclr_msgpack(arch, kinds, tmp_path):
    """The probe's (and caption probe's) ``load_pretrained_encoder`` and
    DETR's ``build_model`` (RLS's too) load the encoder ``f`` of a JAX
    msgpack exactly as ``from_jax_variables`` of the same variables gives
    it; the DETR backbone's FrozenBatchNorm buffers hold its statistics."""
    variables = _jax_variables(arch, **kinds)
    path = str(tmp_path / "checkpoint.msgpack")
    _write_simclr(path, variables)
    want = tckpt.from_jax_variables(variables["params"], variables["batch_stats"])
    cpu = torch.device("cpu")

    encoder = SimCLRModule(arch=arch)
    assert probe_driver.load_pretrained_encoder(encoder, path, cpu)
    got = encoder.f.state_dict()
    assert sorted(got) == sorted(tckpt.encoder_state_dict(want))
    assert all(torch.equal(got[k], v) for k, v in tckpt.encoder_state_dict(want).items())

    cfg = tconfig.parse_into(tconfig.DETRConfig, [
        path, "--dataset", "synthetic", "--backbone", arch, "--num-classes", "10",
        "--hidden_dim", "32", "--nheads", "2", "--enc_layers", "1", "--dec_layers", "1",
        "--dim_feedforward", "64", "--no-bf16"])
    model, _, pretrained = detr_driver.build_model(cfg, cpu)
    ref = _frozen_body_state(arch, want)
    body = model.body.state_dict()
    assert pretrained and sorted(body) == sorted(ref)
    assert all(torch.equal(body[k], v) for k, v in ref.items())


def test_rls_and_probe_drivers_start_from_a_jax_simclr_msgpack(simclr_payload_file, tmp_path,
                                                               capsys):
    """The RLS driver's model (``build_model`` of an ``RLSConfig``) and the
    probe driver's ``-e`` run both start from the JAX-written msgpack."""
    path, variables = simclr_payload_file
    cfg = tconfig.parse_into(tconfig.RLSConfig, [
        path, "--dataset", "synthetic", "--backbone", "ResNet10", "--num-classes", "10",
        "--hidden_dim", "32", "--nheads", "2", "--enc_layers", "1", "--dec_layers", "1",
        "--dim_feedforward", "64", "--no-bf16"])
    model, _, pretrained = detr_driver.build_model(cfg, torch.device("cpu"))
    ref = _frozen_body_state("ResNet10", tckpt.from_jax_variables(variables["params"],
                                                                  variables["batch_stats"]))
    assert pretrained and all(torch.equal(model.body.state_dict()[k], v) for k, v in ref.items())
    prec1, prec5 = probe_driver.main([path, "--dataset", "synthetic", "--arch", "ResNet10",
                                      "-b", "4", "--canvas-size", "64", "-f", "2", "-e", "-t",
                                      "--num-examples", "8", "--num-classes", "10",
                                      "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert "=> loaded pretrained model" in capsys.readouterr().out and 0 <= prec1 <= prec5


@pytest.mark.parametrize("which", ["simclr", "probe", "detr"])
def test_resume_from_a_jax_msgpack_names_the_roadmap_item(simclr_payload_file, which, tmp_path):
    """Resuming a driver of the port from a JAX checkpoint needs its optax
    state in torch form: refused, naming ROADMAP A5, not a KeyError."""
    path, _ = simclr_payload_file
    common = ["--dataset", "synthetic", "-b", "4", "--canvas-size", "64", "-f", "2", "-t",
              "--num-examples", "8", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
              "--resume", path]
    run = {"simclr": lambda: simclr_driver.main(common + ["--arch", "ResNet10"]),
           "probe": lambda: probe_driver.main([""] + common + ["--arch", "ResNet10",
                                                               "--num-classes", "10"]),
           "detr": lambda: detr_driver.main([""] + common + [
               "--backbone", "ResNet10", "--num-classes", "10", "--hidden_dim", "32",
               "--nheads", "2", "--enc_layers", "1", "--dec_layers", "1",
               "--dim_feedforward", "64", "--backbone-norm", "group"])}[which]
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        run()


def test_simclr_state_dict_passes_torch_payloads_through():
    sd = OrderedDict(w=torch.ones(2))
    assert tckpt.simclr_state_dict({"state_dict": sd}) is sd
    assert tckpt.simclr_state_dict(sd) is sd
