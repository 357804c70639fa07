"""The PyTorch port's host input against the JAX package's, on the CPU.

The readers (shard arithmetic, the ImageNet and COCO catalogs, the box
flip), the ``HostLoader`` batch for batch and bit for bit against the JAX
``HostLoader`` (PIL on both sides, and the native decoder on both sides
where it builds), the ``CanvasCache`` served across the two packages in
both directions and rebuilt when it is stale or partial, and the failure
paths of the loader and of ``device_prefetch``. Small images (16-80 px
sources, canvas 40) made with PIL from a numpy seed.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_active_ai_tpu.data import loader as jloader
from multimodal_active_ai_tpu.data import native as jnative
from multimodal_active_ai_tpu.data import prefetch as jprefetch
from multimodal_active_ai_tpu.data import readers as jreaders
from multimodal_active_ai_tpu_torch.data import loader as tloader
from multimodal_active_ai_tpu_torch.data import native as tnative
from multimodal_active_ai_tpu_torch.data import readers as treaders
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches, device_prefetch

CANVAS, B = 40, 4


def write_image(path, rng, kind="rgb", lo=16, hi=81):
    """A random image of odd size: RGB or grayscale JPEG, or RGBA PNG."""
    h, w = (int(x) | 1 for x in rng.randint(lo, hi, 2))
    a = rng.randint(0, 256, (h, w, 3), np.uint8)
    if kind == "gray":
        Image.fromarray(a[..., 0]).save(path, quality=90)
    elif kind == "rgba":
        Image.fromarray(np.dstack([a, a[..., :1]]), "RGBA").save(path)
    else:
        Image.fromarray(a).save(path, quality=90)


def make_folder(root, classes=3, per_class=5, seed=0):
    """``root/class_c/img_i.{jpg,png}``: every third file grayscale JPEG,
    every third RGBA PNG, the rest RGB JPEG."""
    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            kind = ("rgb", "gray", "rgba")[(c * per_class + i) % 3]
            write_image(os.path.join(d, f"img_{i}.{'png' if kind == 'rgba' else 'jpg'}"),
                        rng, kind)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = make_folder(str(tmp_path_factory.mktemp("folder")))
    files, labels, _ = treaders.list_image_folder(root)
    return files, labels


def native_or_skip(decoder):
    """``use_native`` for a decoder name; skips the native case where
    either package's native decoder does not build (no g++ or libjpeg)."""
    if decoder == "native":
        if not (jnative.available() and tnative.available()):
            pytest.skip("native decoder not built here (no g++/libjpeg)")
        return True
    return False


def batches_of(loader, epochs=1):
    out = []
    for _ in range(epochs):
        out += [(np.asarray(im).copy(), np.asarray(lb).copy()) for im, lb in loader]
        loader.reset()
    return out


def assert_same_batches(port, jax):
    assert len(port) == len(jax)
    for (ti, tl), (ji, jl) in zip(port, jax):
        assert ti.dtype == np.uint8 and tl.dtype == np.int64 and jl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


# ---------------------------------------------------------------------------
# readers


@pytest.mark.parametrize("n", [1, 7, 10, 37, 421])
def test_shard_arithmetic_matches_jax(n):
    for shards in (1, 2, 3, 4, 8):
        for shard_id in range(shards):
            for batch in (1, 4, 128):
                for pad in (True, False):
                    assert treaders.compute_shard_size(n, shard_id, shards, batch, pad) == \
                        jreaders.compute_shard_size(n, shard_id, shards, batch, pad)
            files = [f"f{i}" for i in range(n)]
            assert treaders.shard_files(files, shard_id, shards) == \
                jreaders.shard_files(files, shard_id, shards)


def _coco_tree(root, rng):
    images = os.path.join(root, "images")
    os.makedirs(images)
    ims, anns = [], []
    for i in range(5):
        name = f"{i:012d}.jpg"
        write_image(os.path.join(images, name), rng)
        ims.append({"id": 100 + i, "file_name": name, "width": 64.0 + i, "height": 48.0})
        for k in range(i % 3):
            anns.append({"image_id": 100 + i, "bbox": [1.0 + k, 2.0, 10.0, 5.0 + i],
                         "category_id": 7 * k + i})
    anns.append({"image_id": 999, "bbox": [0, 0, 1, 1], "category_id": 1})  # no such image
    anns.append({"image_id": 101, "category_id": 3})                         # no bbox
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"images": ims[::-1], "annotations": anns}, f)
    return images, ann


@pytest.mark.parametrize("annotations", [True, False])
@pytest.mark.parametrize("with_boxes", [True, False])
def test_coco_catalog_matches_jax(tmp_path, annotations, with_boxes):
    images, ann = _coco_tree(str(tmp_path), np.random.RandomState(1))
    ann = ann if annotations else None
    got = treaders.list_coco_images(images, ann, with_boxes=with_boxes)
    want = jreaders.list_coco_images(images, ann, with_boxes=with_boxes)
    if not with_boxes:
        assert got == want and len(got) == 5
        return
    assert got[0] == want[0]
    for mine, theirs in zip(got[1] + got[2], want[1] + want[2]):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


def test_image_folder_catalog_and_box_flip_match_jax(tmp_path):
    root = make_folder(str(tmp_path), classes=2, per_class=3)
    os.makedirs(os.path.join(root, "class_1", "nested"))
    open(os.path.join(root, "class_0", "notes.txt"), "w").close()
    assert treaders.list_image_folder(root) == jreaders.list_image_folder(root)
    assert treaders.IMG_EXTENSIONS == jreaders.IMG_EXTENSIONS
    boxes = np.random.RandomState(2).rand(3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(treaders.bb_hflip(boxes), jreaders.bb_hflip(boxes))


# ---------------------------------------------------------------------------
# HostLoader against the JAX HostLoader, bit for bit


@pytest.mark.parametrize("decoder", ["pil", "native"])
@pytest.mark.parametrize("shuffle,prefetch,shard_id,num_shards", [
    (False, 0, 0, 1), (True, 2, 0, 1), (True, 0, 1, 2), (False, 2, 0, 2)])
def test_host_loader_matches_jax(folder, decoder, shuffle, prefetch, shard_id, num_shards):
    """Images and labels of every batch over two epochs across ``reset()``:
    15 files of three kinds, so each shard's last batch is padded."""
    files, labels = folder
    kw = dict(batch_size=B, canvas_size=CANVAS, shard_id=shard_id, num_shards=num_shards,
              shuffle=shuffle, seed=3, prefetch=prefetch, num_threads=2,
              use_native=native_or_skip(decoder))
    port = tloader.HostLoader(files, labels, **kw)
    jax = jloader.HostLoader(files, labels, **kw)
    assert (len(port), port.shard_size) == (len(jax), jax.shard_size)
    assert port.decoder == decoder
    got, want = batches_of(port, 2), batches_of(jax, 2)
    assert_same_batches(got, want)
    assert len(got) == 2 * len(port) and port.epoch == 2
    assert port.stats["decoded"] == len(port) * B == jax.stats["decoded"]
    if shuffle:         # the two epochs' orders differ
        assert not np.array_equal(got[0][1], got[len(port)][1])


def test_host_loader_without_labels_and_its_stats_line(folder):
    files, _ = folder
    loader = tloader.HostLoader(files, None, batch_size=B, canvas_size=CANVAS,
                                use_native=False, prefetch=0)
    batches = batches_of(loader)
    assert all((lb == -1).all() for _, lb in batches)
    line = loader.stats_line()
    assert line.startswith("loader (pil): 4 batches | produce ")
    assert line.endswith("ms/batch | 16 decoded, 0 cache hits")
    it = iter(loader)                       # a new epoch starts its own counts
    assert loader.stats["batches"] == 0
    it.close()


def test_pinned_batches_or_a_raise(folder):
    """``pin_memory`` gives page-locked batches where there is a card and
    raises where there is none: no silent unpinned fallback."""
    files, labels = folder
    loader = tloader.HostLoader(files, labels, batch_size=B, canvas_size=CANVAS,
                                use_native=False, prefetch=0, pin_memory=True)
    if torch.cuda.is_available():
        images, lbl = next(iter(loader))
        assert images.is_pinned() and lbl.is_pinned()
    else:
        with pytest.raises(RuntimeError):
            next(iter(loader))


# ---------------------------------------------------------------------------
# CanvasCache: one format for both packages


@pytest.mark.parametrize("decoder", ["pil", "native"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_canvas_cache_serves_the_other_package(folder, tmp_path, decoder, writer):
    files, labels = folder
    use_native = native_or_skip(decoder)
    kw = dict(batch_size=B, canvas_size=CANVAS, shuffle=True, seed=5, prefetch=0,
              use_native=use_native, cache_dir=str(tmp_path))
    make = {"jax": jloader.HostLoader, "port": tloader.HostLoader}
    first = make[writer](files, labels, **kw)
    written = batches_of(first)
    assert first.cache.valid_rows(np.arange(15)).all() and first.stats["decoded"] == 16
    reader = make["port" if writer == "jax" else "jax"](files, labels, **kw)
    assert reader.cache.fingerprint == first.cache.fingerprint
    served = batches_of(reader)
    assert reader.stats["decoded"] == 0 and reader.stats["cache_hits"] == 16
    port, jax = (served, written) if writer == "jax" else (written, served)
    assert_same_batches(port, jax)


def test_canvas_cache_fingerprint_holds_the_decoder(folder, tmp_path):
    files, labels = folder
    kw = dict(batch_size=B, canvas_size=CANVAS, prefetch=0, cache_dir=str(tmp_path))
    pil = tloader.HostLoader(files, labels, use_native=False, **kw)
    jax_pil = jloader.HostLoader(files, labels, use_native=False, **kw)
    assert pil.cache.fingerprint == jax_pil.cache.fingerprint
    assert tloader.CanvasCache(str(tmp_path), files, CANVAS, decoder_id="native").fingerprint \
        != pil.cache.fingerprint


@pytest.mark.parametrize("change", ["mtime", "size", "partial"])
def test_canvas_cache_rebuilds_when_stale_or_partial(tmp_path, change):
    root = make_folder(str(tmp_path / "data"), classes=1, per_class=6)
    files, labels, _ = treaders.list_image_folder(root)
    kw = dict(batch_size=B, canvas_size=CANVAS, prefetch=0, use_native=False,
              cache_dir=str(tmp_path / "cache"))
    first = tloader.HostLoader(files, labels, **kw)
    batches_of(first)
    if change == "mtime":
        st = os.stat(files[2])
        os.utime(files[2], ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    elif change == "size":
        write_image(files[2], np.random.RandomState(9), "rgba" if files[2].endswith("png")
                    else "rgb", lo=90, hi=120)
    else:                           # the .u8 deleted, its .json and .flags kept
        os.remove(first.cache.data_path)
    again = tloader.HostLoader(files, labels, **kw)
    assert (again.cache.fingerprint == first.cache.fingerprint) == (change == "partial")
    got = batches_of(again)
    assert again.stats["decoded"] == 8 and again.stats["cache_hits"] == 0
    fresh = batches_of(tloader.HostLoader(files, labels, **{**kw, "cache_dir": None}))
    assert_same_batches(got, [(im, lb.astype(np.int32)) for im, lb in fresh])


def test_canvas_cache_size_guard(tmp_path, monkeypatch):
    monkeypatch.setenv("MAAI_CANVAS_CACHE_MAX_GB", "0.000001")
    with pytest.raises(RuntimeError, match="MAAI_CANVAS_CACHE_MAX_GB"):
        tloader.CanvasCache(str(tmp_path), ["a", "b"], CANVAS)


def test_canvas_cache_read_rows_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    files = [f"f{i}" for i in range(9)]
    port = tloader.CanvasCache(str(tmp_path / "p"), files, 8)
    jax = jloader.CanvasCache(str(tmp_path / "j"), files, 8)
    for i in (0, 1, 2, 5, 8):
        img = rng.randint(0, 256, (8, 8, 3), np.uint8)
        port.put(i, img)
        jax.put(i, img)
    rows = np.array([8, 1, 2, 0, 5, 5])
    np.testing.assert_array_equal(port.valid_rows(np.arange(9)), jax.valid_rows(np.arange(9)))
    out_p, out_j = np.zeros((7, 8, 8, 3), np.uint8), np.zeros((7, 8, 8, 3), np.uint8)
    positions = np.array([6, 0, 1, 3, 4, 2])
    port.read_rows(rows, out_p, positions)
    jax.read_rows(rows, out_j, positions)
    np.testing.assert_array_equal(out_p, out_j)
    assert port.valid_rows(np.arange(9)).sum() == jax.hits == 5


# ---------------------------------------------------------------------------
# failure paths and shutdown


def _threads(*names):
    return [t for t in threading.enumerate() if t.name in names and t.is_alive()]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_corrupt_file_raises(tmp_path, prefetch):
    root = make_folder(str(tmp_path), classes=1, per_class=4)
    files, labels, _ = treaders.list_image_folder(root)
    with open(files[1], "wb") as f:
        f.write(b"not an image")
    loader = tloader.HostLoader(files, labels, batch_size=2, canvas_size=CANVAS,
                                prefetch=prefetch, use_native=False)
    with pytest.raises(Exception) as info:
        list(loader)
    if prefetch:        # forwarded from the producer thread
        assert info.type is RuntimeError and "producer failed" in str(info.value)
        assert info.value.__cause__ is not None
    assert not _threads("HostLoader-producer")


def test_closing_early_stops_the_producer_and_the_prefetch_thread(folder):
    files, labels = folder
    loader = tloader.HostLoader(files, labels, batch_size=2, canvas_size=CANVAS,
                                prefetch=1, use_native=False)
    it = device_batches(loader, torch.device("cpu"), depth=1)
    images, lbl = next(it)
    assert images.shape == (2, CANVAS, CANVAS, 3) and lbl.dtype == torch.int64
    assert _threads("HostLoader-producer") and _threads("device_prefetch")
    it.close()
    assert not _threads("HostLoader-producer", "device_prefetch")


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_prefetch_keeps_order_like_jax(depth):
    got = list(device_prefetch(iter(range(20)), lambda x: x * x, depth=depth))
    assert got == list(jprefetch.device_prefetch(iter(range(20)), lambda x: x * x,
                                                 depth=depth)) == [x * x for x in range(20)]


def test_device_prefetch_is_the_identity_at_depth_0():
    seen = []
    it = device_prefetch(iter(range(3)), lambda x: seen.append(x) or x, depth=0)
    assert seen == [] and next(it) == 0 and seen == [0]
    assert not _threads("device_prefetch")


@pytest.mark.parametrize("where", ["source", "put"])
def test_device_prefetch_forwards_an_exception(where):
    def source():
        yield 1
        if where == "source":
            raise ValueError("bad source")
        yield 2

    def put(x):
        if where == "put" and x == 2:
            raise ValueError("bad put")
        return x

    it = device_prefetch(source(), put, depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="device prefetch failed") as info:
        next(it)
    assert isinstance(info.value.__cause__, ValueError)
    assert not _threads("device_prefetch")


def test_device_batches_on_the_cpu_yields_the_batches():
    batches = [(torch.full((2, 3), i, dtype=torch.uint8), torch.tensor([i, -i]))
               for i in range(4)]
    got = list(device_batches(iter(batches), torch.device("cpu"), depth=2))
    assert all(a is x and b is y for (a, b), (x, y) in zip(got, batches))


def test_native_decode_batch_validates_its_output(folder):
    files, _ = folder
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        tnative.decode_batch(files[:2], CANVAS, np.empty((2, CANVAS, CANVAS, 3), np.int32))
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        tnative.decode_batch(files[:2], CANVAS, np.empty((3, CANVAS, CANVAS, 3), np.uint8))
