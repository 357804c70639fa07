"""``optimizer.device_ms``: device ms a step of the kernels inside the
profiler's ``Optimizer.step#*`` ranges (rank 0's card)."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    us = trace.time_under(run.trace, "Optimizer.step#")
    return us / 1e3 / run.trace_steps if us else None
