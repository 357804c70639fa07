"""``device.idle_pct``: the share of an untraced step in which the card is
idle: 100 × (1 − device busy time a step / the window's step time). The
busy time is the union of the kernel, memset and copy intervals of the
traced steps (averaged over the cards); the step time is the untraced
window's, because the profiler's own host work stretches the traced steps
(two to three times here), which would count as idle."""


def read(run):
    busy = [b for b in run.busy_s if b]
    if not busy:
        return None
    per_step = sum(busy) / len(busy) / run.trace_steps
    return 100.0 * (1.0 - per_step / (run.window_s / run.steps))
