"""``glimpse_sample.roofline_pct``: B1's least time (its least bytes from
the launches' plans, ``flops.b1_bytes``, at the card's memory rate) over
its device time, both summed over the traced launches, in %."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    us = [k.end - k.start for k in run.trace.kernels if "glimpse_sample" in k.name]
    if not us or len(us) != len(run.b1_bytes):
        return None
    least_us = sum(run.b1_bytes) / run.peaks["hbm_bytes_per_s"] * 1e6
    return 100.0 * least_us / sum(us)
