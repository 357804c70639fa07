"""``moe.experts_roofline_pct``: the held experts' forward stage's least
time over its device time, in %.

The stage is what runs inside a ``models.lm.moe.experts`` span: the held
experts' float32 weights cast to the rows' dtype, their grouped products
(``gate_up_proj``, SwiGLU, ``down_proj``) over the routed rows. Its least
time a call is the larger of its operations at the card's bf16 peak and
its bytes at the memory rate (``peaks.py``): operations ``2·rows·3·d·w``
(``d`` the hidden width, ``w`` the expert width), bytes each input read
once and each output written once (the held experts' float32 weights, the
routed rows in and out in bf16). ``rows`` is the mean a call over the run
and the shape that of the held experts, both from the port's MoE counters
(``models/moe.counts``). The device time is
that of the kernels that start inside the spans' device ranges; the calls
are the ranges. None where the trace holds no such range, the counters
are absent (a program without the mixture of experts) or the card has no
known peaks."""

import bisect

from benchmark import trace

NAME = "models.lm.moe.experts"


def expert_ops(rows: float, d: int, w: int) -> float:
    return 2.0 * rows * 3 * d * w


def expert_bytes(rows: float, held: int, d: int, w: int) -> float:
    return held * 3 * d * w * 4 + rows * d * 2 * 2


def _shape():
    """``(held, d, w, mean rows a call)`` from the port's counters."""
    try:
        from multimodal_active_ai_tpu_torch.models import moe
    except ImportError:
        return None
    got = moe.counts()
    if not got.get("calls"):
        return None
    return got["held"], got["hidden"], got["width"], got["rows"] / got["calls"]


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    shape = _shape()
    calls = [a for a in run.trace.annotations if a.name == NAME]
    if shape is None or not calls:
        return None
    held, d, w, rows = shape
    ranges = trace.merged(sorted(calls, key=lambda a: a.start))
    starts = [r[0] for r in ranges]
    us = 0.0
    for k in run.trace.kernels:
        i = bisect.bisect_right(starts, k.start) - 1
        if i >= 0 and k.start < ranges[i][1]:
            us += k.end - k.start
    if not us:
        return None
    least_s = max(expert_ops(rows, d, w) / run.peaks["bf16_flops"],
                  expert_bytes(rows, held, d, w) / run.peaks["hbm_bytes_per_s"])
    return 100.0 * len(calls) * least_s * 1e6 / us
