"""Profiling and tracing on ``torch.profiler`` and ``torch.cuda``.

Port of ``multimodal_active_ai_tpu/utils/profiling.py``: :func:`trace`
captures a profile around a block (written as a Chrome trace when given a
directory), :func:`device_leaf_ops` lists the device work of a profile,
:class:`StepTimer` is the reference's ``synchronize(); time()`` step timer
(``Contrastive_Learning.py:721-723``) and :func:`device_memory_stats` reads
the allocator's per-card counters. ``tools/profile_torch_step.py`` reads
its traces through :func:`device_leaf_ops`, so the two cannot count device
time differently.
"""

from __future__ import annotations

import contextlib
import os
from time import perf_counter

import torch


def device_leaf_ops(prof: torch.profiler.profile) -> list[tuple[str, float]]:
    """``(name, µs)`` for every kernel, memset and copy that ran on a CUDA
    device during ``prof``. The device ranges of user annotations (such as
    ``Optimizer.step#Adam.step``) are left out: they span kernels already
    counted. A profile without CUDA activity gives ``[]``."""
    return [(e.name, float(e.device_time_total)) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


@contextlib.contextmanager
def trace(log_dir: str | None = None, enabled: bool = True):
    """Profile the block (CPU activity, and CUDA activity where a card is
    present); yields the ``torch.profiler.profile`` (None when not
    ``enabled``). With ``log_dir``, the Chrome trace is written to
    ``log_dir/trace.json`` (Perfetto, ``chrome://tracing``)::

        with profiling.trace() as prof:
            step(state, images, gen)
            torch.cuda.synchronize()
        busy_us = sum(us for _, us in profiling.device_leaf_ops(prof))
    """
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Synchronised per-step wall timer (the reference's
    ``cuda.synchronize(); time()`` pattern as an object)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.times: list[float] = []

    def start(self) -> None:
        self._t0 = perf_counter()

    def stop(self, *sync_on: torch.Tensor) -> float:
        """Wait for the devices of the tensors ``sync_on`` to finish their
        queued work, then record and return the seconds since
        :meth:`start`."""
        for dev in {t.device for t in sync_on if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        dt = perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def avg(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self, items_per_step: int = 0) -> str:
        if not self.times:
            return "no steps recorded"
        avg = self.avg
        line = f"steps={len(self.times)} avg={avg * 1e3:.2f}ms"
        if items_per_step:
            line += f" throughput={items_per_step / avg:.1f}/s"
        return line


def device_memory_stats() -> dict:
    """``{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` from
    the caching allocator of each card; ``{}`` without CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats
