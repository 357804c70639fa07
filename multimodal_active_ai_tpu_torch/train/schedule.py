"""Learning-rate schedule: linear/sqrt scaling + linear warmup + cosine decay.

Port of ``multimodal_active_ai_tpu/train/schedule.py`` (reference
``SimCLR/Model_Util.py:9-60``) as a plain float function of the number of
optimizer updates already made, counting from 0: under warmup the first
update uses ``lr(0) = 0``. The optimizer steps once per fixation, so that
is the count the trainer passes.
"""

from __future__ import annotations

import math
from typing import Callable


def scaled_lr(base_learning_rate: float, global_batch_size: int,
              scaling: str = "linear") -> float:
    """``linear``: lr·gbs/256; ``sqrt``: lr·√gbs (``Model_Util.py:20-28``)."""
    if scaling == "linear":
        return base_learning_rate * global_batch_size / 256.0
    if scaling == "sqrt":
        return base_learning_rate * math.sqrt(global_batch_size)
    raise ValueError(f"Unknown learning rate scaling {scaling}")


def simclr_learning_rate(base_learning_rate: float, global_batch_size: int,
                         num_examples: int, batch_size: int,
                         warmup_epochs: int, train_epochs: int,
                         scaling: str = "linear") -> Callable[[int], float]:
    """``schedule(step) -> lr`` of ``Model_Util.learning_rate_schedule``:
    ``warmup_steps = warmup_epochs·num_examples // batch_size`` and
    ``total_steps = num_examples·train_epochs // batch_size + 1``, with
    ``num_examples``/``batch_size`` the per-rank shard size and batch."""
    lr = scaled_lr(base_learning_rate, global_batch_size, scaling)
    warmup_steps = int(round(warmup_epochs * num_examples // batch_size))
    total_steps = num_examples * train_epochs // batch_size + 1
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / warmup_steps * lr
        t = min(step - warmup_steps, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * t / decay_steps))

    return schedule
