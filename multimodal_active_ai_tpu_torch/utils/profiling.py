"""Profiling and tracing on ``torch.profiler`` and ``torch.cuda``.

Port of ``multimodal_active_ai_tpu/utils/profiling.py``: :func:`trace`
captures a profile around a block (written as a Chrome trace when given a
directory), :func:`span` names a range of the program in such a profile,
:func:`span_table` says where a profile's host and device time went by
span, :func:`device_leaf_ops` lists the device work of a profile,
:class:`StepTimer` is the reference's ``synchronize(); time()`` step timer
(``Contrastive_Learning.py:721-723``) and :func:`device_memory_stats` reads
the allocator's per-card counters. ``tools/profile_torch_step.py`` reads
its traces through :func:`device_leaf_ops`, so the two cannot count device
time differently.
"""

from __future__ import annotations

import bisect
import contextlib
import os
from time import perf_counter
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str, args=None):
    """A named range of the program: ``torch.profiler.record_function(name)``
    while a profiler runs, so the range lands in the profile beside the
    kernels it launches, on the profiler's clock; otherwise one shared
    no-op context, which costs a flag check. ``args`` (the root span's
    update count) goes to ``record_function`` as a string. The port's spans
    are named ``<layer>.<what>`` (``trainers.step``, ``retina.sample``,
    ``models.encoder.layer1``), and no name holds a fragment by which a
    kernel's name is grouped (``conv``, ``copy``, ``index``, ``normal``,
    ``reduce``, ``softmax``, ...)::

        with span("trainers.step", state.step):
            ...
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name, None if args is None else str(args))


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


class SpanRow(NamedTuple):
    """One span name's share of a profile (:func:`span_table`)."""

    name: str
    count: int            # host ranges of the name
    host_ms: float        # their summed length
    host_self_ms: float   # less the part their child spans cover on the same thread
    device_ms: float      # kernels linked to the name as the innermost span
    idle_ms: float        # device idle time with the name the innermost span open


NO_SPAN = "(no span)"
_ROOTS = ("trainers.step", "trainers.eval_step")
_BEFORE_BACKWARD = ("trainers.loss", "trainers.backward")


def span_table(prof: torch.profiler.profile) -> list[SpanRow]:
    """Where a profile's host and device time went, by span name (the
    port's :func:`span` ranges and torch's own, such as
    ``Optimizer.step#Adam.step``), most device time first; see
    :func:`span_rows`. On the CPU the device columns are 0."""
    host, notes, device = [], [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (notes if e.is_user_annotation else device).append((e.name, start, end))
        elif e.is_user_annotation:
            host.append((e.name, start, end, e.thread))
    return span_rows(host, notes, device)


def _merged(ranges) -> list[list[float]]:
    out: list[list[float]] = []
    for start, end in sorted(ranges):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(merged: list[list[float]], starts: list[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < merged[i][1]


def span_rows(host, notes, device) -> list[SpanRow]:
    """The table of :func:`span_table` from plain tuples (µs): ``host``
    ``(name, start, end, thread)`` of the spans' host ranges, ``notes``
    ``(name, start, end)`` of their device ranges, ``device`` ``(name,
    start, end)`` of the kernels, memsets and copies.

    A kernel is linked to the innermost span open on the thread that
    launched it, and a span's device range runs from its first linked
    kernel to its last, so each kernel goes to the latest-starting range
    around it, the step's roots (``trainers.step``, ``trainers.eval_step``)
    counting only where no other range holds it. On a card autograd
    launches the backward from a thread of its own, with no span open:
    a kernel in no range whose latest range to end before it is a
    ``trainers.loss`` or ``trainers.backward`` one goes to
    ``trainers.backward`` (one stream runs a step's kernels in launch
    order). Kernels in no range otherwise, and idle gaps between the
    device's busy intervals whose midpoint falls in no host span, go to
    :data:`NO_SPAN`. Memsets and copies count toward the busy intervals
    only."""
    rows: dict[str, list] = {}

    def row(name):
        return rows.setdefault(name, [0, 0.0, 0.0, 0.0, 0.0])

    # host: length and self length (same-thread children nest strictly)
    by_thread: dict = {}
    for name, start, end, thread in host:
        by_thread.setdefault(thread, []).append((start, -end, name))
    for spans in by_thread.values():
        stack: list[list] = []                   # [end, name, own length]
        for start, neg_end, name in sorted(spans):
            end = -neg_end
            while stack and stack[-1][0] <= start:
                done = stack.pop()
                row(done[1])[2] += done[2]
            r = row(name)
            r[0] += 1
            r[1] += end - start
            if stack:
                stack[-1][2] -= end - start
            stack.append([end, name, end - start])
        for done in stack:
            row(done[1])[2] += done[2]

    # device: each kernel to its innermost range, or the backward rule
    phases = sorted((n for n in notes if n[0] not in _ROOTS), key=lambda n: n[1])
    roots = sorted((n for n in notes if n[0] in _ROOTS), key=lambda n: n[1])
    p_starts = [n[1] for n in phases]
    p_cover = _merged((n[1], n[2]) for n in phases)
    p_cover_starts = [r[0] for r in p_cover]
    by_end = sorted(phases, key=lambda n: (n[2], -n[1]))
    ends = [n[2] for n in by_end]
    r_cover = _merged((n[1], n[2]) for n in roots)
    r_cover_starts = [r[0] for r in r_cover]
    r_starts = [n[1] for n in roots]
    for kname, start, end in device:
        if kname.startswith(("Memset", "Memcpy")):
            continue
        if _inside(p_cover, p_cover_starts, start):
            i = bisect.bisect_right(p_starts, start) - 1
            while phases[i][2] <= start:
                i -= 1
            owner = phases[i][0]
        else:
            j = bisect.bisect_right(ends, start) - 1
            if j >= 0 and by_end[j][0] in _BEFORE_BACKWARD:
                owner = "trainers.backward"
            elif _inside(r_cover, r_cover_starts, start):
                owner = roots[bisect.bisect_right(r_starts, start) - 1][0]
            else:
                owner = NO_SPAN
        row(owner)[3] += end - start

    # idle: the gaps between busy intervals, by the innermost host span open
    busy = _merged((d[1], d[2]) for d in device)
    spans = sorted(host, key=lambda h: h[1])
    h_starts = [h[1] for h in spans]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(h_starts, mid) - 1
        while i >= 0 and spans[i][2] <= mid:
            i -= 1
        row(spans[i][0] if i >= 0 else NO_SPAN)[4] += b - a

    out = [SpanRow(name, n, host_us / 1e3, self_us / 1e3, dev_us / 1e3, idle_us / 1e3)
           for name, (n, host_us, self_us, dev_us, idle_us) in rows.items()]
    return sorted(out, key=lambda r: (-r.device_ms, -r.host_ms, r.name))


# span names → the layer whose kernels :func:`span_layers` sums them into
# (first match wins; what no prefix matches is "rest of the step")
LAYERS = [
    ("retina.", "retina"), ("models.", "models"), ("trainers.loss", "loss"),
    ("trainers.backward", "backward"), ("Optimizer.zero_grad#", "backward"),
    ("trainers.update", "update"), ("trainers.clip", "update"),
    ("Optimizer.step#", "update"), ("collectives.grad_mean", "update"),
    (NO_SPAN, "outside the program"),
]


def span_layers(rows) -> dict[str, float]:
    """Device ms of :func:`span_table` rows summed by :data:`LAYERS`: every
    kernel of a profile falls in exactly one layer."""
    out = {layer: 0.0 for _, layer in LAYERS} | {"rest of the step": 0.0}
    for r in rows:
        layer = next((lay for prefix, lay in LAYERS if r.name.startswith(prefix)),
                     "rest of the step")
        out[layer] += r.device_ms
    return out


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
