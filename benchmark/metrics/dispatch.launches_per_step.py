"""``dispatch.launches_per_step``: kernels launched a step in the traced
stretch on rank 0's card, memsets and copies not counted."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.kernels) / run.trace_steps
