"""``dispatch.idle_outside_program_pct``: the share of the traced steps'
device idle time (the gaps between the card's busy intervals) whose
midpoint falls in no host ``trainers.step`` span: time the card waited
while the host was outside the program, in the benchmark's own work of a
step (its draws) or between calls. The rest of the idle time falls inside
the program's steps. None where the trace holds no ``trainers.step`` span
or no gap (a program without the spans, or no card)."""

import bisect

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = trace.merged(sorted((s for s in tr.host if s.name == "trainers.step"),
                                key=lambda s: s.start))
    gaps = tr.gaps()
    if not steps or not gaps:
        return None
    starts = [s[0] for s in steps]
    outside = 0.0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid >= steps[i][1]:
            outside += b - a
    return 100.0 * outside / sum(b - a for a, b in gaps)
