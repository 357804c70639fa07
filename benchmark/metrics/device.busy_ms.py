"""``device.busy_ms``: device ms a step in which some kernel, memset or
copy ran, the union of their intervals over the traced steps (averaged
over the cards). The host's pace does not enter it, so it stays steady
where the rate of a host-bound cell swings with the host's speed."""


def read(run):
    busy = [b for b in run.busy_s if b]
    if not busy:
        return None
    return 1e3 * sum(busy) / len(busy) / run.trace_steps
