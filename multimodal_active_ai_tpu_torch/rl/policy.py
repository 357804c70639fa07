"""ε-greedy saccade-action selection.

Port of ``multimodal_active_ai_tpu/rl/policy.py`` (reference
``DQN/Training.py:21-68``): the ε schedule, the greedy and random
actions, and :func:`select_action`, ε-greedy with one coin per call. The
rollout (``train/rls_train.py``) draws its coins itself, one per fixation
for the whole batch, on the host where it branches on them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def eps_threshold(epoch: int, eps_start: float, eps_end: float, eps_decay: float) -> float:
    """``eps_end + (eps_start − eps_end)·exp(−epoch / eps_decay)``
    (``Training.py:32-33``, decayed by *epoch*, not step)."""
    return eps_end + (eps_start - eps_end) * math.exp(-1.0 * epoch / eps_decay)


def greedy_action(qx: torch.Tensor, qy: torch.Tensor, num_of_actions: int) -> torch.Tensor:
    """Each head's argmax (the first maximal index) ``k`` as the fraction
    ``k·(1/A)`` in float32, ``(B, 2)`` (x, y). The JAX rollout writes
    ``argmax / A``, and XLA compiles a division by a constant into a product
    with its float32 reciprocal, so the fractions it stores are these (at
    A = 100 they differ from ``k/100`` by 1 ulp for 30 of the 100 bins, 22
    of which the loss reads back one bin lower; the port keeps all of it)."""
    recip = float(np.float32(1) / np.float32(num_of_actions))
    bins = torch.stack([qx.argmax(dim=1), qy.argmax(dim=1)], dim=1)
    return bins.to(torch.float32) * recip


@torch.no_grad()
def select_action_from_policy(model: torch.nn.Module, states: torch.Tensor,
                              num_of_actions: int) -> torch.Tensor:
    """Greedy action of ``model`` on ``states`` (``Training.py:57-68``,
    :func:`greedy_action`). The model runs in eval mode (its mode is
    restored after). Returns ``(B, 2)`` fractional coordinates (x, y)."""
    was_training = model.training
    model.eval()
    try:
        qx, qy = model(states)
    finally:
        model.train(was_training)
    return greedy_action(qx, qy, num_of_actions)


def select_random_action(generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """Uniform random fixation ``(B, 2)`` in [0, 1)² on ``generator``'s
    device (``Training.py:53-54``)."""
    return torch.rand((batch_size, 2), generator=generator, device=generator.device)


def select_action(model: torch.nn.Module, states: torch.Tensor, generator: torch.Generator,
                  host_generator: torch.Generator, *, epoch: int, eps_start: float,
                  eps_end: float, eps_decay: float, num_of_actions: int) -> torch.Tensor:
    """ε-greedy (``Training.py:21-49``) with one shared coin per call: the
    whole batch explores or exploits together, as the reference's single
    rank-0 ``random.random()`` decides. The coin comes from the CPU
    ``host_generator`` (the branch is taken on the host), the random
    fixations from ``generator``. Returns ``(B, 2)`` (x, y) in [0, 1)."""
    coin = float(torch.rand((), generator=host_generator))
    if coin > eps_threshold(epoch, eps_start, eps_end, eps_decay):
        return select_action_from_policy(model, states, num_of_actions)
    return select_random_action(generator, states.shape[0])
