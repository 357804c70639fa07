"""``step.mfu``: the benchmark's analytic operations of the window's steps
(``flops.py``) over the window's wall time and the cards' bf16 peak, in %."""


def read(run):
    if run.peaks is None:
        return None
    return 100.0 * run.flops_per_step * run.steps / run.window_s / (
        run.peaks["bf16_flops"] * run.world)
