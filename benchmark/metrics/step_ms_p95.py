"""``step_ms_p95``: the 95th percentile of the window's step times, each
the time between the CUDA events recorded after consecutive steps."""

import statistics


def read(run):
    if len(run.step_ms) < 20:
        return None
    return statistics.quantiles(run.step_ms, n=100, method="inclusive")[94]
