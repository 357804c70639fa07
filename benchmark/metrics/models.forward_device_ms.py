"""``models.forward_device_ms``: device ms a step of the kernels that start
inside the device ranges of the program's ``models.*`` spans (the encoder
and its stages, SimCLR's projector, DETR's input projection, transformer
and head): the forwards, SimCLR's view 0 under ``no_grad`` included, on
rank 0's card. A kernel is linked to the innermost span open where it was
launched, so the ranges of one prefix nest and abut: they are merged
before the kernels are counted. None where the trace holds no such range
(a program without the spans, or no card)."""

import bisect

from benchmark import trace

PREFIX = "models."


def read(run):
    if run.trace is None:
        return None
    ranges = trace.merged(sorted((a for a in run.trace.annotations if a.name.startswith(PREFIX)),
                                 key=lambda a: a.start))
    if not ranges:
        return None
    starts = [r[0] for r in ranges]
    us = 0.0
    for k in run.trace.kernels:
        i = bisect.bisect_right(starts, k.start) - 1
        if i >= 0 and k.start < ranges[i][1]:
            us += k.end - k.start
    return us / 1e3 / run.trace_steps
