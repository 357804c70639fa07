"""Host→device prefetch: the copy of batch N+1 overlaps the step on batch N.

The port's counterpart of ``multimodal_active_ai_tpu/data/prefetch.py``.
The reference leans on DALI's ``prefetch_queue_depth`` to keep batches
ready ahead of the consumer (``NVIDIA_DALI_Pipelines.py:30-32``). The host
half, decode and cache gather, is overlapped by
:class:`~multimodal_active_ai_tpu_torch.data.loader.HostLoader`'s own
queue; :func:`device_prefetch` overlaps the second half, the transfer.

:func:`device_batches` is what the drivers call. On CUDA it copies each
pinned batch ``non_blocking`` on a side stream; the consumer's current
stream waits on that copy's event before anything it enqueues afterwards,
and each device tensor is marked with ``record_stream``, so the caching
allocator does not give its memory to the side stream's next copy while a
step on the consumer's stream still reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

# seconds between is-the-consumer-gone checks while parked on a full queue
_PUT_TIMEOUT = 5.0


def device_prefetch(batches: Iterable, put: Callable, depth: int = 2) -> Iterator:
    """Yield ``put(batch)`` for each batch, with up to ``depth`` calls of
    ``put`` made ahead of the consumer by a worker thread.

    Exceptions from ``batches`` or from ``put`` re-raise at the consumer's
    next ``next()`` (as a ``RuntimeError`` whose cause they are).
    ``depth=0`` is the synchronous identity pipeline. Closing the iterator
    stops and joins the worker, then closes the source iterator.
    """
    source = iter(batches)
    try:
        if depth <= 0:
            for b in source:
                yield put(b)
            return
        yield from _threaded(source, put, depth)
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


def _threaded(source: Iterator, put: Callable, depth: int) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def blocking_put(item) -> bool:
        """A put that never gives up while the consumer is alive: a bounded
        one would drop the end or exception sentinel when the consumer
        stalls past it with a full queue, and leave it parked on ``q.get()``."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_TIMEOUT)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in source:
                if stop.is_set() or not blocking_put(put(b)):
                    return
            blocking_put(end)
        except BaseException as exc:  # noqa: BLE001 - forwarded to the consumer
            blocking_put(exc)

    t = threading.Thread(target=worker, daemon=True, name="device_prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("device prefetch failed") from item
            yield item
    finally:
        stop.set()
        while t.is_alive():     # free a worker parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)


def device_batches(batches: Iterable, device: torch.device, depth: int = 0) -> Iterator:
    """Yield each batch (a tuple of tensors) on ``device``, through
    :func:`device_prefetch` at ``depth``.

    On CUDA the copies run ``non_blocking`` on one side stream; every
    yielded tensor is ready on the consumer's current stream (it waits on
    the copy's event) and is recorded on that stream. Tensors already on
    the device (the synthetic reader's) pass through. On the CPU a tensor
    is the batch's own.
    """
    if device.type != "cuda":
        yield from device_prefetch(batches, lambda b: tuple(t.to(device) for t in b), depth)
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(side):
            out = tuple(t.to(device, non_blocking=True) for t in batch)
            return out, side.record_event()

    for out, copied in device_prefetch(batches, put, depth):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(copied)
        for t in out:
            t.record_stream(stream)
        yield out
