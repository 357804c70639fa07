"""Host data loader: sharded file reading, JPEG decode, prefetch, and the
decode-once canvas cache.

The port's counterpart of ``multimodal_active_ai_tpu/data/loader.py``. The
reference decodes JPEGs on its GPU with DALI (``ops.ImageDecoder``,
``NVIDIA_DALI_Pipelines.py:48``); the JAX package decodes on the host CPU,
with PIL or the native decoder of :mod:`.native`, into fixed-size uint8
canvases, double-buffered ahead of the device, and the port does the same,
so that both packages give the same batches from the same files. All
per-pixel augmentation stays in the retina, on the device.

The contract of the reference's reader pipes (pipe1/pipe3,
``Contrastive_Learning.py:290-328``): a contiguous shard per process,
``pad_last_batch``, an optional shuffle (the DETR classifier trains with
``random_shuffle=True``, ``DETR_Image_Classification.py:263``) and an epoch
``reset()``.

PyTorch idiom: a batch is a ``torch.uint8 (B, S, S, 3)`` CPU tensor and
``int64 (B,)`` labels (``-1`` where the catalog has none). With
``pin_memory`` (set by the drivers when the device is CUDA) both are
allocated in page-locked memory, a fresh block per batch, so the copy to
the card is a DMA; PyTorch's caching host allocator does not hand a block
out again before the ``non_blocking`` copy that read it has completed.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter

import numpy as np
import torch

from multimodal_active_ai_tpu_torch.data import readers
from multimodal_active_ai_tpu_torch.utils.profiling import span


class CanvasCache:
    """Decode-once raw-canvas cache: a per-shard uint8 memmap of decoded
    ``(canvas, canvas, 3)`` images and a row-validity byte per row.

    The first epoch pays the decode once; later epochs, and later runs,
    stream raw canvases from the page cache or the disk. The format is the
    JAX package's (``data/loader.py:CanvasCache``), so a cache written by
    either package serves the other: the same fingerprint (sha256 over
    ``canvas|shard/num|n|decoder_id|`` and each file's path, size and
    ``mtime_ns``), the same ``canvas_{S}_{fp}.json/.u8/.flags`` names, and
    the same rebuild of a stale or partial pair of files.
    """

    def __init__(self, cache_dir: str, files: list[str], canvas: int,
                 shard_id: int = 0, num_shards: int = 1, decoder_id: str = ""):
        os.makedirs(cache_dir, exist_ok=True)
        fp = hashlib.sha256()
        fp.update(f"{canvas}|{shard_id}/{num_shards}|{len(files)}|{decoder_id}|".encode())
        for f in files:
            fp.update(f.encode())
            # size and mtime: a dataset regenerated in place at the same
            # paths must rebuild the cache, not serve stale canvases
            try:
                st = os.stat(f)
                fp.update(f"|{st.st_size}|{st.st_mtime_ns}".encode())
            except OSError:
                pass
            fp.update(b"\0")
        self.fingerprint = fp.hexdigest()[:16]
        base = os.path.join(cache_dir, f"canvas_{canvas}_{self.fingerprint}")
        self.meta_path = base + ".json"
        self.data_path = base + ".u8"
        self.flag_path = base + ".flags"
        self.n = len(files)
        self.canvas = canvas
        # an n*canvas*canvas*3 memmap per shard: refuse, above a limit the
        # environment can raise, before sparse-allocating terabytes
        size_gb = self.n * canvas * canvas * 3 / 1e9
        limit_gb = float(os.environ.get("MAAI_CANVAS_CACHE_MAX_GB", "256"))
        if size_gb > limit_gb:
            raise RuntimeError(
                f"canvas cache would hold {size_gb:.1f} GB for this shard "
                f"({self.n} images at {canvas}x{canvas}x3 uint8), above the "
                f"{limit_gb:.0f} GB guard; raise MAAI_CANVAS_CACHE_MAX_GB "
                "to proceed or drop --canvas-cache")
        if size_gb > 1.0:
            print(f"canvas cache: up to {size_gb:.1f} GB at {cache_dir} "
                  f"({self.n} images, canvas {canvas})")
        meta = {"n": self.n, "canvas": canvas, "fingerprint": self.fingerprint}
        if os.path.isfile(self.meta_path):
            try:
                with open(self.meta_path) as f:
                    stale = json.load(f) != meta
            except (ValueError, OSError):
                stale = True        # a truncated meta file: rebuild
            if stale:
                os.remove(self.meta_path)
        # reuse only when all three files survive: a partial set (a run
        # killed mid-create, or the .u8 deleted while all-ones .flags stay)
        # would serve zeroed canvases flagged as valid
        reuse = (os.path.isfile(self.meta_path) and os.path.isfile(self.data_path)
                 and os.path.isfile(self.flag_path))
        if not reuse:
            for p in (self.data_path, self.flag_path):
                if os.path.isfile(p):
                    os.remove(p)
            with open(self.meta_path, "w") as f:
                json.dump(meta, f)
        mode = "r+" if reuse else "w+"
        self._data = np.memmap(self.data_path, np.uint8, mode, shape=(self.n, canvas, canvas, 3))
        self._flags = np.memmap(self.flag_path, np.uint8, mode, shape=(self.n,))

    def valid_rows(self, rows: np.ndarray) -> np.ndarray:
        """Bool mask of which of ``rows`` are decoded."""
        return self._flags[rows].astype(bool)

    def read_rows(self, rows: np.ndarray, out: np.ndarray, positions: np.ndarray) -> None:
        """``out[positions] = data[rows]`` in one numpy gather: a per-row
        Python loop holds the interpreter lock long enough to starve a
        transfer thread on few-core hosts."""
        self._advise_willneed(rows)
        out[positions] = self._data[rows]

    def _advise_willneed(self, rows: np.ndarray) -> None:
        """``madvise(MADV_WILLNEED)`` the runs of rows about to be gathered,
        so the kernel reads a cold cache ahead instead of faulting it in
        4 KiB at a time. Skipped where the mmap or ``madvise`` is missing."""
        mm = getattr(self._data, "_mmap", None)
        madvise = getattr(mm, "madvise", None)
        if madvise is None:
            return
        import mmap as _mmap

        if not hasattr(_mmap, "MADV_WILLNEED"):
            return
        srt = np.sort(np.asarray(rows, np.int64))
        if srt.size == 0:
            return
        row_bytes = self.canvas * self.canvas * 3
        page = _mmap.PAGESIZE
        breaks = np.nonzero(np.diff(srt) > 1)[0]          # contiguous [start, stop] runs
        starts = np.concatenate(([0], breaks + 1))
        stops = np.concatenate((breaks, [len(srt) - 1]))
        try:
            for a, b in zip(srt[starts], srt[stops]):
                off = int(a) * row_bytes // page * page
                madvise(_mmap.MADV_WILLNEED, off, (int(b) + 1) * row_bytes - off)
        except (OSError, ValueError):
            pass

    def put(self, i: int, img: np.ndarray) -> None:
        self._data[i] = img
        self._flags[i] = 1


def _put_until(q: queue.Queue, item, stop: threading.Event) -> bool:
    """A put that gives up only when the consumer has signalled shutdown,
    so an abandoned iterator cannot leave the producer parked on a full
    queue. The consumer drains the queue after setting ``stop``, which
    frees a parked put at once; the long timeout keeps timed-wait wakeups
    from churning the interpreter lock on few-core hosts."""
    while not stop.is_set():
        try:
            q.put(item, timeout=5.0)
            return True
        except queue.Full:
            continue
    return False


def _decode_resize_pil(path: str, canvas: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((canvas, canvas), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


class HostLoader:
    """Threaded, double-buffered producer of ``(images, labels)`` batches.

    The JAX ``HostLoader``'s arguments and semantics: ``shard_id`` of
    ``num_shards`` contiguous shards, each padded by repeating its final
    sample (``shard_size`` examples, ``len()`` batches); ``shuffle`` with
    ``np.random.RandomState(seed + epoch)``, ``reset()`` moving to the next
    epoch; ``prefetch`` batches decoded ahead by a producer thread with
    ``num_threads`` decode threads, or with ``prefetch=0`` each batch made
    in the consumer's thread; ``use_native`` the native decoder (None: where
    it builds; True raises where it does not); ``cache_dir`` the
    :class:`CanvasCache`. ``stats`` and
    :meth:`stats_line` describe the current epoch; the consumer's wait for a
    prefetched batch (``stats["wait_s"]``) is also an ``input.wait`` span
    under a profiler. ``pin_memory`` allocates each batch in page-locked
    memory.
    """

    def __init__(self, files, labels=None, batch_size: int = 256, canvas_size: int = 640,
                 shard_id: int = 0, num_shards: int = 1, shuffle: bool = False,
                 seed: int = 15, prefetch: int = 2, num_threads: int = 4,
                 use_native: bool | None = None, cache_dir: str | None = None,
                 pin_memory: bool = False):
        self.all_files = list(files)
        self.all_labels = list(labels) if labels is not None else None
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.pin_memory = pin_memory
        self.epoch = 0
        self._native = None
        if use_native is not False:
            from multimodal_active_ai_tpu_torch.data import native
            if native.available():
                self._native = native
            elif use_native:
                raise RuntimeError("use_native=True but the native decoder does not build "
                                   "here (it needs make, g++ and libjpeg)")

        self._base_index = readers.shard_files(list(range(len(self.all_files))),
                                               shard_id, num_shards)
        self.shard_size = readers.compute_shard_size(len(self.all_files), shard_id,
                                                     num_shards, batch_size)
        # the cache's rows are shard-local positions; _cache_pos maps a
        # global file index to its row
        self.cache = None
        self._cache_pos = {}
        if cache_dir:
            # the decoder is part of the fingerprint: native and PIL
            # canvases differ, and neither may serve the other
            self.cache = CanvasCache(cache_dir, [self.all_files[i] for i in self._base_index],
                                     canvas_size, shard_id, num_shards,
                                     decoder_id=self.decoder)
            self._cache_pos = {fi: j for j, fi in enumerate(self._base_index)}
        self.stats = self._fresh_stats()

    @property
    def decoder(self) -> str:
        """``'native'`` or ``'pil'``: the decoder that makes this loader's canvases."""
        return "native" if self._native is not None else "pil"

    @staticmethod
    def _fresh_stats() -> dict:
        return {"decode_s": 0.0, "wait_s": 0.0, "batches": 0, "decoded": 0, "cache_hits": 0}

    def __len__(self):
        return -(-self.shard_size // self.batch_size)

    def reset(self):
        """Epoch boundary, the reference's ``pipe.reset()`` (``Contrastive_Learning.py:541``)."""
        self.epoch += 1

    def _epoch_order(self) -> list[int]:
        order = list(self._base_index)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        want = len(self) * self.batch_size      # pad_last_batch
        while len(order) < want:
            order.append(order[-1])
        return order

    def stats_line(self) -> str:
        """One line: the decoder, and produce time, consumer wait, decodes
        and cache hits of the current epoch."""
        s = self.stats
        b = max(s["batches"], 1)
        return (f"loader ({self.decoder}): {s['batches']} batches | "
                f"produce {1000 * s['decode_s'] / b:.1f} ms/batch | "
                f"consumer wait {1000 * s['wait_s'] / b:.1f} ms/batch | "
                f"{s['decoded']} decoded, {s['cache_hits']} cache hits")

    def _produce_batch(self, sel: list[int], pool: ThreadPoolExecutor):
        """One ``(images, labels)`` batch: cache reads, then a native or PIL
        decode of the rest, then the cache write-back."""
        s = self.canvas_size
        images_t = torch.empty((self.batch_size, s, s, 3), dtype=torch.uint8,
                               pin_memory=self.pin_memory)
        labels_t = torch.empty((self.batch_size,), dtype=torch.int64,
                               pin_memory=self.pin_memory)
        images, labels = images_t.numpy(), labels_t.numpy()
        if self.all_labels is not None:
            labels[:] = [self.all_labels[i] for i in sel]
        else:
            labels[:] = -1

        need = list(range(len(sel)))
        if self.cache is not None:
            rows = np.fromiter((self._cache_pos.get(fi, -1) for fi in sel), np.int64, len(sel))
            valid = rows >= 0
            valid[valid] = self.cache.valid_rows(rows[valid])
            hit_pos = np.nonzero(valid)[0]
            if hit_pos.size:
                self.cache.read_rows(rows[hit_pos], images, hit_pos)
            need = list(np.nonzero(~valid)[0])
            self.stats["cache_hits"] += int(hit_pos.size)
        if need:
            misses = need
            if self._native is not None:
                paths = [self.all_files[sel[j]] for j in need]
                tmp = images if len(need) == len(sel) else np.empty((len(need), s, s, 3),
                                                                    np.uint8)
                ok = self._native.decode_batch(paths, s, tmp, num_threads=self.num_threads)
                if tmp is not images:
                    for k, j in enumerate(need):
                        if ok[k]:
                            images[j] = tmp[k]
                misses = [need[k] for k in range(len(need)) if not ok[k]]
            if misses:      # PIL, or what the native decoder refused (a PNG)
                def dec(j):
                    images[j] = _decode_resize_pil(self.all_files[sel[j]], s)
                list(pool.map(dec, misses))
            if self.cache is not None:
                for j in need:
                    row = self._cache_pos.get(sel[j])
                    if row is not None:
                        self.cache.put(row, images[j])
            self.stats["decoded"] += len(need)
        return images_t, labels_t

    def __iter__(self):
        order = self._epoch_order()
        self.stats = self._fresh_stats()
        if self.prefetch == 0:
            # in the consumer's thread: on few-core hosts a producer's long
            # lock-holding copies can stall a host-to-device transfer
            return self._iter_sync(order)
        return self._iter_threaded(order)

    def _batches(self, order: list[int]):
        for b in range(len(self)):
            yield order[b * self.batch_size:(b + 1) * self.batch_size]

    def _iter_sync(self, order):
        with ThreadPoolExecutor(max_workers=max(self.num_threads, 1)) as pool:
            for sel in self._batches(order):
                t0 = perf_counter()
                item = self._produce_batch(sel, pool)
                self.stats["decode_s"] += perf_counter() - t0
                self.stats["batches"] += 1
                yield item

    def _iter_threaded(self, order):
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # one decode pool an epoch: PIL releases the interpreter lock
            # while it decodes and resizes, so its threads run in parallel
            try:
                with ThreadPoolExecutor(max_workers=max(self.num_threads, 1)) as pool:
                    for sel in self._batches(order):
                        if stop.is_set():
                            return
                        t0 = perf_counter()
                        item = self._produce_batch(sel, pool)
                        self.stats["decode_s"] += perf_counter() - t0
                        if not _put_until(out_q, item, stop):
                            return
                _put_until(out_q, None, stop)
            except BaseException as exc:  # noqa: BLE001 - forwarded to the consumer
                _put_until(out_q, exc, stop)

        t = threading.Thread(target=producer, daemon=True, name="HostLoader-producer")
        t.start()
        try:
            while True:
                t0 = perf_counter()
                with span("input.wait"):
                    item = out_q.get()
                self.stats["wait_s"] += perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError("HostLoader producer failed") from item
                self.stats["batches"] += 1
                yield item
        finally:
            stop.set()
            while t.is_alive():     # free a producer parked on a full queue
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)
