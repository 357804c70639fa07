"""``trainers.backward_device_ms``: device ms a step of the autograd
backward, on rank 0's card. The program opens a ``trainers.backward`` span
around ``zero_grad`` and ``backward()``, but on a card autograd launches
the backward's kernels from a thread of its own, and a kernel is linked to
the spans open on the thread that launched it, so that span's device range
holds few kernels or none. Counted are the kernels inside a
``trainers.backward`` range, and every kernel inside no range of a span
but the step's root (``trainers.step``, ``trainers.eval_step``) whose
latest range to end before it is a ``trainers.loss`` or
``trainers.backward`` range: the step's kernels run on one stream in
launch order, and the backward runs between the loss and the update. None
where the trace holds no ``trainers.loss`` range (a program without the
spans, or no card)."""

import bisect

from benchmark import trace

ROOTS = ("trainers.step", "trainers.eval_step")
BEFORE = ("trainers.loss", "trainers.backward")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    phases = [a for a in tr.annotations if a.name not in ROOTS]
    if not any(a.name == "trainers.loss" for a in phases):
        return None
    inside = trace.merged(sorted(phases, key=lambda a: a.start))
    starts = [r[0] for r in inside]
    # by end; of ranges that end together, the outer one (earliest start) last
    by_end = sorted(phases, key=lambda a: (a.end, -a.start))
    ends = [a.end for a in by_end]
    backward = trace.merged(sorted((a for a in phases if a.name == "trainers.backward"),
                                   key=lambda a: a.start))
    b_starts = [r[0] for r in backward]
    us = 0.0
    for k in tr.kernels:
        i = bisect.bisect_right(b_starts, k.start) - 1
        if i >= 0 and k.start < backward[i][1]:
            us += k.end - k.start
            continue
        i = bisect.bisect_right(starts, k.start) - 1
        if i >= 0 and k.start < inside[i][1]:
            continue
        j = bisect.bisect_right(ends, k.start) - 1
        if j >= 0 and by_end[j].name in BEFORE:
            us += k.end - k.start
    return us / 1e3 / run.trace_steps
