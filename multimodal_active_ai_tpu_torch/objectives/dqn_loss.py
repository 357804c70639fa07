"""DQN Bellman objective for the saccade policy (Huber loss).

Port of ``multimodal_active_ai_tpu/objectives/dqn_loss.py`` (reference
``DQN/Training.py:86-140``): Q(s, a) is the mean of the x/y head values
gathered at the taken action, V(s') the mean of the target heads' maxima,
and the loss SmoothL1(Q, r + γ·V') with β = 1 (``Training.py:127-129``).
The action index is ``(a · A)`` truncated to int32 **in float32**, as both
the JAX package and the reference compute it: a stored greedy fraction can
come back one bin lower (at A = 100, 53/100 and 59/100 even under exact
division, and 22 bins for the fractions the JAX rollout stores, see
``rl/policy.greedy_action``), and the port keeps that.
"""

from __future__ import annotations

import torch


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """torch ``nn.SmoothL1Loss`` elementwise (β = ``delta``)."""
    absx = x.abs()
    return torch.where(absx < delta, 0.5 * x * x / delta, absx - 0.5 * delta)


def action_indices(actions: torch.Tensor, num_of_actions: int) -> torch.Tensor:
    """``(B, 2)`` fractional float32 actions → ``(B, 2)`` int64 bins, the
    product taken in float32 and truncated (``Training.py:106-109``)."""
    return (actions.to(torch.float32) * num_of_actions).to(torch.int32).long()


def dqn_bellman_loss(policy_qx: torch.Tensor, policy_qy: torch.Tensor,
                     target_qx: torch.Tensor, target_qy: torch.Tensor,
                     actions: torch.Tensor, rewards: torch.Tensor,
                     gamma: float, num_of_actions: int) -> torch.Tensor:
    """Single-step Bellman Huber loss: the policy heads ``(B, A)`` on the
    states, the target heads ``(B, A)`` on the next states (no gradient
    flows into them), ``actions`` ``(B, 2)`` in [0, 1) as stored in the
    replay memory, ``rewards`` ``(B,)``."""
    idx = action_indices(actions, num_of_actions)
    q_x = policy_qx.gather(1, idx[:, 0:1])[:, 0]
    q_y = policy_qy.gather(1, idx[:, 1:2])[:, 0]
    state_action_values = (q_x + q_y) / 2.0                  # Training.py:110-112
    next_state_values = (target_qx.detach().amax(dim=1)
                         + target_qy.detach().amax(dim=1)) / 2.0  # :118-122
    expected = next_state_values * gamma + rewards            # Training.py:125
    return huber(state_action_values - expected).mean()
