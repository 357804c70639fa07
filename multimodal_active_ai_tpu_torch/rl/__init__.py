"""rl of the PyTorch port (see the package docstring): the DQN replay
memory and the saccade-action selection."""

from multimodal_active_ai_tpu_torch.rl.policy import (
    eps_threshold,
    greedy_action,
    select_action_from_policy,
    select_random_action,
)
from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory, Transition

__all__ = [
    "ReplayMemory",
    "Transition",
    "eps_threshold",
    "greedy_action",
    "select_action_from_policy",
    "select_random_action",
]
