"""``train_images_per_s``: source images of the global batch whose whole
training step finished in the window, over the window's wall time (all
steps, all the time, the last step's device work included)."""


def read(run):
    return run.steps * run.images_per_step / run.window_s
