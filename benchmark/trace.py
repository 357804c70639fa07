"""What the benchmark reads from a ``torch.profiler`` trace.

Frozen copies of two pieces of the port: the event filter of
``utils/profiling.device_leaf_ops`` (every kernel, memset and copy that ran
on a CUDA device, without the device ranges of user annotations, which
span kernels already counted) and the kernel-name groups of
``tools/profile_torch_step.py`` (``GROUPS``), which name the breakdown
only and feed no metric. On top of them: the union of the device
intervals (busy time), the idle gaps between them named by the host
operation open in each, and the device ranges of user annotations such as
``Optimizer.step#Adam.step``.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import NamedTuple

import torch

GROUPS = [
    ("glimpse_sample", "retina sampler (B1)"),
    ("stat_sums", "BN statistics kernel (B2)"),
    ("conv1x1_stats", "1x1 conv + statistics kernel (B3)"),
    ("conv", "convolution"), ("gemm", "matmul/conv gemm"), ("sm90_", "matmul/conv gemm"),
    ("cutlass", "matmul/conv gemm"), ("cudnn", "convolution"), ("nchw", "convolution"),
    ("nhwc", "convolution"), ("wgrad", "convolution"), ("dgrad", "convolution"),
    ("reduce", "reductions (BN statistics, losses)"),
    ("multi_tensor_apply", "optimizer"), ("foreach", "optimizer"),
    ("softmax", "softmax / layer norm"), ("layer_norm", "softmax / layer norm"),
    ("elementwise", "elementwise (BN, ReLU, casts)"), ("copy", "copies / casts"),
    ("index", "gather / index"), ("randn", "random"), ("normal", "random"),
    ("uniform", "random"),
]


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


class Span(NamedTuple):
    name: str
    start: float   # µs
    end: float


class Trace(NamedTuple):
    device: list[Span]        # kernels, memsets and copies, by start
    annotations: list[Span]   # device ranges of user annotations
    host: list[Span]          # host operations, by start
    window_us: float          # the traced wall time

    @property
    def kernels(self) -> list[Span]:
        return [s for s in self.device if not s.name.startswith(("Memset", "Memcpy"))]

    def busy_us(self) -> float:
        return sum(e - s for s, e in merged(self.device))

    def gaps(self) -> list[tuple[float, float]]:
        spans = merged(self.device)
        return [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]


def parse(prof: torch.profiler.profile, window_us: float) -> Trace:
    device, annotations, host = [], [], []
    for e in prof.events():
        span = Span(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (annotations if e.is_user_annotation else device).append(span)
        elif not e.name.startswith(("cuda", "cu")) and span.end > span.start:
            host.append(span)
    device.sort(key=lambda s: s.start)
    host.sort(key=lambda s: s.start)
    return Trace(device, annotations, host, window_us)


def merged(spans: list[Span]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s in spans:
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return [tuple(x) for x in out]


def host_op_at(host: list[Span], starts: list[float], t: float, lookback: int = 4000) -> str:
    """The innermost host operation open at ``t`` (the latest started that
    has not ended), or ``idle host``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if host[j].end > t:
            return host[j].name
    return "idle host"


def named_gaps(tr: Trace) -> Counter:
    """Idle seconds of the device by what the host was doing, named by the
    groups where a group fits and by the host operation otherwise."""
    starts = [s.start for s in tr.host]
    out: Counter = Counter()
    for a, b in tr.gaps():
        op = host_op_at(tr.host, starts, 0.5 * (a + b))
        group = group_of(op)
        out[op[:80] if group == "other" else group] += (b - a) / 1e6
    return out


def device_ops(tr: Trace) -> Counter:
    """Device seconds by kernel group (or name, where no group fits)."""
    out: Counter = Counter()
    for s in tr.device:
        group = group_of(s.name)
        out[s.name[:80] if group == "other" else group] += (s.end - s.start) / 1e6
    return out


def time_under(tr: Trace, prefix: str) -> float:
    """Device µs of the kernels that start inside the device range of a
    user annotation whose name starts with ``prefix``."""
    ranges = sorted((a.start, a.end) for a in tr.annotations if a.name.startswith(prefix))
    if not ranges:
        return 0.0
    starts = [r[0] for r in ranges]
    total = 0.0
    for k in tr.kernels:
        i = bisect.bisect_right(starts, k.start) - 1
        if i >= 0 and k.start < ranges[i][1]:
            total += k.end - k.start
    return total
