"""The port's drivers on image files, on the CPU.

``build_reader`` and the caption driver's catalog (files, captions, the
templated ``imagefolder`` captions and the corpus vocabulary) against the
JAX drivers' on the same folders; the LR schedule's ``num_examples``
against the JAX driver's; and one run of each of the five drivers on a
small ImageNet-layout folder with ``--canvas-cache`` and ``-v``
(ResNet10, canvas 64, b=4): each trains, writes its checkpoint and prints
its loader line, and a resumed SimCLR run is served from the cache alone.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu import config as jconfig
from multimodal_active_ai_tpu.models import text as jtext
from multimodal_active_ai_tpu.train import schedule as jschedule
from multimodal_active_ai_tpu_torch import coco_captions_probe as cap_driver
from multimodal_active_ai_tpu_torch import config as tconfig
from multimodal_active_ai_tpu_torch import contrastive_learning as simclr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification_rls as rls_driver
from multimodal_active_ai_tpu_torch import representation_evaluation as probe_driver
from multimodal_active_ai_tpu_torch.data.loader import HostLoader
from multimodal_active_ai_tpu_torch.models import text as ttext
from multimodal_active_ai_tpu_torch.train import schedule as tschedule
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

import coco_captions_probe as jcap_driver
import contrastive_learning as jsimclr_driver
from test_torch_port_data import write_image

B = 4
COMMON = ["-b", str(B), "--canvas-size", "64", "-f", "2", "-t", "-p", "1", "--epochs", "1",
          "--device", "cpu", "-v", "-j", "2"]


def imagenet_folder(root, train=6, val=4, classes=2, seed=0):
    """``root/{train,val}/class_c/*.JPEG`` of odd sizes: 6 train images
    make 2 batches of 4, the last padded."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", train), ("val", val)):
        for i in range(n):
            d = os.path.join(root, split, f"n{i % classes:08d}")
            os.makedirs(d, exist_ok=True)
            write_image(os.path.join(d, f"img_{i}.JPEG"), rng)
    return root


def coco_folder(root, seed=1):
    """``root/MSCOCO/cocoapi/{images/{train,val}2014, annotations}`` with
    instances and caption annotations."""
    rng = np.random.RandomState(seed)
    api = os.path.join(root, "MSCOCO", "cocoapi")
    os.makedirs(os.path.join(api, "annotations"))
    for sub, n in (("train2014", 6), ("val2014", 4)):
        d = os.path.join(api, "images", sub)
        os.makedirs(d)
        ims, anns, caps = [], [], []
        for i in range(n):
            name = f"COCO_{sub}_{i:012d}.jpg"
            write_image(os.path.join(d, name), rng)
            ims.append({"id": 7 + i, "file_name": name, "width": 64, "height": 48})
            anns.append({"image_id": 7 + i, "bbox": [1, 2, 3, 4], "category_id": i})
            caps += [{"image_id": 7 + i, "caption": f"A photo of thing {i} and {k} more"}
                     for k in range(1 + i % 2)]
        with open(os.path.join(api, "annotations", f"instances_{sub}.json"), "w") as f:
            json.dump({"images": ims[::-1], "annotations": anns}, f)
        with open(os.path.join(api, "annotations", f"captions_{sub}.json"), "w") as f:
            json.dump({"images": ims, "annotations": caps}, f)
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The driver runs use one intra-op thread: their models are tiny, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    flat = os.path.join(base, "flat")
    rng = np.random.RandomState(2)
    os.makedirs(flat)
    for i in range(5):
        write_image(os.path.join(flat, f"a_b_{i}.jpg"), rng)
    with open(os.path.join(flat, "notes.txt"), "w"):
        pass
    ilsvrc = os.path.join(base, "ilsvrc")
    imagenet_folder(os.path.join(ilsvrc, "ImageNet", "ILSVRC", "Data", "CLS-LOC"), seed=3)
    return {"imagenet": imagenet_folder(os.path.join(base, "imagenet")),
            "ilsvrc": ilsvrc,
            "imagenet_flat": imagenet_folder(os.path.join(base, "imagenet_flat"))
            + "/train",
            "mscoco": coco_folder(os.path.join(base, "coco")),
            "flat": flat}


# ---------------------------------------------------------------------------
# catalogs against the JAX drivers'


@pytest.mark.parametrize("layout,dataset", [
    ("imagenet", "imagenet"), ("ilsvrc", "imagenet"), ("imagenet_flat", "imagenet"),
    ("mscoco", "mscoco"), ("flat", "mscoco")])
@pytest.mark.parametrize("split", ["train", "val"])
def test_build_reader_matches_jax(folders, layout, dataset, split):
    argv = [folders[layout], "--dataset", dataset, "-b", str(B), "--canvas-size", "32"]
    port = simclr_driver.build_reader(tconfig.parse_into(tconfig.ContrastiveConfig, argv),
                                      split, torch.device("cpu"))
    jax = jsimclr_driver.build_reader(jconfig.parse_into(jconfig.ContrastiveConfig, argv),
                                      split, 0, 1, batch_size=B)
    assert isinstance(port, HostLoader) and not port.pin_memory and not port.shuffle
    assert port.all_files == jax.all_files and len(port.all_files) > 0
    assert port.all_labels == jax.all_labels
    assert (port.shard_size, len(port), port.canvas_size, port.num_threads) == \
        (jax.shard_size, len(jax), jax.canvas_size, jax.num_threads)
    assert simclr_driver.epoch_examples(port) == jax.shard_size


def test_schedule_examples_match_jax(folders):
    """The LR schedule counts a loader's ``shard_size``, as the JAX driver
    does (6 here: DALI pads an epoch to a multiple of the shards, not of
    the batch); the synthetic reader's count stays its own."""
    argv = [folders["imagenet"], "--dataset", "imagenet", "-b", str(B)]
    port = simclr_driver.build_reader(tconfig.parse_into(tconfig.ContrastiveConfig, argv),
                                      "train", torch.device("cpu"))
    jax = jsimclr_driver.build_reader(jconfig.parse_into(jconfig.ContrastiveConfig, argv),
                                      "train", 0, 1, batch_size=B)
    n = simclr_driver.epoch_examples(port)
    assert n == jax.shard_size == 6
    ours = tschedule.simclr_learning_rate(0.01, B, n, B, 1, 3)
    theirs = jschedule.simclr_learning_rate(0.01, B, jax.shard_size, B, 1, 3)
    for step in range(12):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)
    synthetic = tconfig.parse_into(tconfig.ContrastiveConfig,
                                   ["--dataset", "synthetic", "-b", "4", "--num-examples", "10"])
    assert simclr_driver.epoch_examples(
        simclr_driver.build_reader(synthetic, "train", torch.device("cpu"))) == 10


@pytest.mark.parametrize("layout", ["mscoco", "captions_json", "flat", "imagefolder"])
def test_caption_catalog_and_vocabulary_match_jax(folders, tmp_path, layout):
    data = folders.get(layout)
    if layout == "captions_json":           # a captions*.json beside the images
        data = str(tmp_path)
        images = os.path.join(folders["mscoco"], "MSCOCO", "cocoapi", "images", "train2014")
        for name in os.listdir(images):
            os.symlink(os.path.join(images, name), os.path.join(data, name))
        ann = os.path.join(folders["mscoco"], "MSCOCO", "cocoapi", "annotations",
                           "captions_train2014.json")
        os.symlink(ann, os.path.join(data, "captions_mine.json"))
    elif layout == "imagefolder":
        data = folders["imagenet"]
    dataset = "imagefolder" if layout == "imagefolder" else "mscoco"
    argv = ["m", data, "--dataset", dataset, "--vocab-size", "12", "--max-len", "6"]
    cfg = tconfig.parse_into(tconfig.CaptionProbeConfig, argv)
    files, captions = cap_driver.caption_catalog(cfg)
    if dataset == "imagefolder":
        from multimodal_active_ai_tpu.data.readers import list_image_folder
        want_files, labels, classes = list_image_folder(os.path.join(data, "train"))
        want_caps = jcap_driver.imagefolder_captions(labels, classes)
        assert cap_driver.imagefolder_captions(labels, classes) == want_caps
    else:
        want_files, want_caps = jcap_driver.load_caption_pairs(
            jconfig.parse_into(jcap_driver.CaptionProbeConfig, argv))
    assert (files, captions) == (want_files, want_caps) and len(files) >= 5
    ours = ttext.Vocabulary.build(captions, max_size=12, max_len=6)
    theirs = jtext.Vocabulary.build(captions, max_size=12, max_len=6)
    assert ours.words == theirs.words
    assert [ours.encode(c) for c in captions] == [theirs.encode(c) for c in captions]


@pytest.mark.parametrize("dataset", ["imagenet", "mscoco"])
def test_missing_data_directory_raises(tmp_path, dataset):
    for data in ([], [str(tmp_path / "absent")]):
        cfg = tconfig.parse_into(tconfig.EvalConfig, ["m"] + data + ["--dataset", dataset])
        with pytest.raises(FileNotFoundError, match="no data directory"):
            simclr_driver.build_reader(cfg, "train", torch.device("cpu"))
    cfg = tconfig.parse_into(tconfig.CaptionProbeConfig,
                             ["m", str(tmp_path / "absent"), "--dataset", "imagefolder"])
    with pytest.raises(FileNotFoundError, match="no data directory"):
        cap_driver.caption_catalog(cfg)


# ---------------------------------------------------------------------------
# the five drivers on image files, with the canvas cache


@pytest.fixture(scope="module")
def simclr_run(folders, tmp_path_factory):
    """The SimCLR driver on the ImageNet folder, cache cold; its output."""
    ck = str(tmp_path_factory.mktemp("simclr"))
    cache = str(tmp_path_factory.mktemp("cache"))
    argv = [folders["imagenet"], "--dataset", "imagenet", "--arch", "ResNet10",
            "--checkpoint-dir", ck, "--canvas-cache", cache] + COMMON
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = simclr_driver.main(argv)
    return {"argv": argv, "ck": os.path.join(ck, "checkpoint.pth.tar"), "cache": cache,
            "out": out.getvalue(), "state": state}


def test_simclr_driver_on_files_and_its_resume_from_the_cache(simclr_run, capsys):
    out = simclr_run["out"]
    assert "loader (" in out and "2 batches" in out and "8 decoded, 0 cache hits" in out
    payload = tckpt.load_checkpoint(simclr_run["ck"])
    assert payload["epoch"] == 1 and payload["step"] == simclr_run["state"].step == 2 * 2
    assert all(np.isfinite(payload["loss_history"]))
    resumed = simclr_driver.main(simclr_run["argv"] + ["--epochs", "2",
                                                       "--resume", simclr_run["ck"]])
    out = capsys.readouterr().out
    assert "=> loaded checkpoint" in out and "0 decoded, 8 cache hits" in out
    assert resumed.step == 2 * 2 * 2


def test_probe_driver_on_files(simclr_run, folders, tmp_path, capsys, monkeypatch):
    seen = {}
    real = probe_driver.schedule.simclr_learning_rate

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(probe_driver.schedule, "simclr_learning_rate", spy)
    state = probe_driver.main([simclr_run["ck"], folders["imagenet"], "--dataset", "imagenet",
                               "--arch", "ResNet10", "--num-classes", "2",
                               "--checkpoint-dir", str(tmp_path),
                               "--canvas-cache", simclr_run["cache"]] + COMMON)
    out = capsys.readouterr().out
    assert "0 decoded, 8 cache hits" in out and "##Top-1" in out
    assert state.step == 2 and seen["num_examples"] == 6
    assert os.path.isfile(tmp_path / "classifier_checkpoint.pth.tar")


def test_detr_driver_on_files_shuffles_its_train_reader(simclr_run, folders, tmp_path, capsys,
                                                        monkeypatch):
    readers = []
    real = detr_driver.build_reader
    monkeypatch.setattr(detr_driver, "build_reader",
                        lambda *a: readers.append(real(*a)) or readers[-1])
    state = detr_driver.main([simclr_run["ck"], folders["imagenet"], "--dataset", "imagenet",
                              "--backbone", "ResNet10", "--num-classes", "2",
                              "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32",
                              "--nheads", "2", "--dim_feedforward", "64", "--checkpoint-dir",
                              str(tmp_path), "--canvas-cache", simclr_run["cache"]] + COMMON)
    out = capsys.readouterr().out
    assert "loader (" in out and "cache hits" in out and state.step == 2
    assert [r.shuffle for r in readers] == [True, False]
    assert os.path.isfile(tmp_path / "detr_classifier_checkpoint.pth.tar")


def test_rls_driver_on_files(simclr_run, folders, tmp_path, capsys):
    state, _ = rls_driver.main([
        simclr_run["ck"], folders["imagenet"], "--dataset", "imagenet", "--backbone",
        "ResNet10", "--dqn", "ResNet10", "--num-classes", "2", "--enc_layers", "1",
        "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2", "--dim_feedforward", "64",
        "--num_queries", "5", "-dqnb", "4", "--replay-memory-capacity", "8",
        "--target-update-freq", "1", "--num-of-actions", "10", "--checkpoint-dir",
        str(tmp_path), "--canvas-cache", simclr_run["cache"]] + COMMON)
    out = capsys.readouterr().out
    assert "8 cache hits" in out and "##Policy Top-1" in out and state.step == 2
    assert os.path.isfile(tmp_path / "dqn_checkpoint.pth.tar")


@pytest.mark.parametrize("dataset", ["imagefolder", "mscoco"])
def test_caption_driver_on_files(simclr_run, folders, tmp_path, capsys, dataset):
    data = folders["imagenet" if dataset == "imagefolder" else "mscoco"]
    argv = [simclr_run["ck"], data, "--dataset", dataset, "-a", "ResNet10",
            "--checkpoint-dir", str(tmp_path), "--canvas-cache", str(tmp_path / "c")] + COMMON
    state, vocab = cap_driver.main(argv)
    out = capsys.readouterr().out
    files, captions = cap_driver.caption_catalog(
        tconfig.parse_into(tconfig.CaptionProbeConfig, argv))
    assert f"caption vocabulary: {vocab.size} entries (cap 32768) over {len(captions)}" in out
    assert vocab.words == ttext.Vocabulary.build(captions).words
    steps = -(-len(files) // B)
    assert "loader (" in out and f"{steps * B} decoded" in out
    assert state.step == steps and "##I2T Top-1" in out
    payload = tckpt.load_checkpoint(str(tmp_path / "caption_probe_checkpoint.pth.tar"))
    assert payload["vocab_size"] == vocab.size
    assert ttext.Vocabulary.from_u8(payload["vocab_words_u8"]).words == vocab.words
    if dataset != "imagefolder":
        return
    # the resume keeps the checkpoint's vocabulary, and warns when the
    # captions on disk would build another
    resumed_state, resumed_vocab = cap_driver.main(argv + ["--vocab-size", "8", "--resume",
                                                           str(tmp_path /
                                                               "caption_probe_checkpoint.pth.tar")])
    out = capsys.readouterr().out
    assert "WARNING: caption corpus changed" in out and resumed_vocab.words == vocab.words
