"""``setup_s``: seconds from the start of the run to the start of the
window: imports, the kernel build where it happens, the seed's weights, the
image pool, the checked steps and the warm-up, which runs until the step
time settles and sizes the window."""


def read(run):
    return run.setup_s
