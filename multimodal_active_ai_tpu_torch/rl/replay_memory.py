"""Replay memory of the DQN saccade policy, a ring on the device.

Port of ``multimodal_active_ai_tpu/rl/replay_memory.py`` (reference
``DQN/Replay_Memory.py:16-36``): a bounded cyclic buffer of ``(state,
action, next_state, reward)`` transitions, pushed a batch at a time and
sampled uniformly without replacement.

The ring lives on the device it is given, the card in the RLS driver. At the
defaults (capacity 10,000, two ``(30, 30, 12)`` float32 states a
transition) it holds 0.86 GB; a ring on the host would instead copy every
step's pushed glimpses off the card and every sampled batch back. A push
writes at most two contiguous slices (the ring wraps once); a sample
gathers its rows with one index on the device.

The sampled indices are drawn on the host with
``np.random.RandomState(seed).choice(size, n, replace=False)``, as the JAX
ring draws them, so the same pushes and seed sample the same rows in both
packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Transition(NamedTuple):
    """(s, a, s', r), reference ``Replay_Memory.py:16-17``."""

    state: torch.Tensor
    action: torch.Tensor
    next_state: torch.Tensor
    reward: torch.Tensor


class ReplayMemory:
    """Uniform-sampling ring buffer (``Replay_Memory.py:23-36``) of float32
    tensors on ``device``."""

    def __init__(self, capacity: int, state_shape, action_dim: int = 2, seed: int = 0,
                 device: torch.device | str = "cpu"):
        self.capacity = capacity
        self.state_shape = tuple(state_shape)
        f32 = dict(dtype=torch.float32, device=device)
        self._states = torch.zeros((capacity,) + self.state_shape, **f32)
        self._actions = torch.zeros((capacity, action_dim), **f32)
        self._next_states = torch.zeros((capacity,) + self.state_shape, **f32)
        self._rewards = torch.zeros((capacity,), **f32)
        self._size = 0
        self._head = 0
        self._rng = np.random.RandomState(seed)

    def _arrays(self) -> tuple[torch.Tensor, ...]:
        return self._states, self._actions, self._next_states, self._rewards

    def push(self, state, action, next_state, reward) -> None:
        """Append a batch of transitions (first axis = batch). Of a batch
        longer than the ring only its last ``capacity`` rows stay, as with
        the JAX ring's wrapped writes."""
        rows = [torch.as_tensor(x) for x in (state, action, next_state, reward)]
        n = rows[0].shape[0]
        skip = max(n - self.capacity, 0)
        head = (self._head + skip) % self.capacity
        first = min(n - skip, self.capacity - head)
        for dst, src in zip(self._arrays(), rows):
            src = src[skip:]
            dst[head:head + first].copy_(src[:first])
            dst[:n - skip - first].copy_(src[first:])
        self._head = (self._head + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Transition:
        """Uniform random batch without replacement (``Replay_Memory.py:32-33``)."""
        if self._size < batch_size:
            raise ValueError(f"sample of {batch_size} from a memory of {self._size}")
        idx = self._rng.choice(self._size, size=batch_size, replace=False)
        idx = torch.from_numpy(idx).to(self._states.device)
        return Transition(*(a.index_select(0, idx) for a in self._arrays()))

    def __len__(self) -> int:
        return self._size

    def state_dict(self) -> dict:
        """The first ``len(self)`` slots of each array (copies), as the JAX
        ring returns them."""
        n = self._size
        return {"states": self._states[:n].clone(), "actions": self._actions[:n].clone(),
                "next_states": self._next_states[:n].clone(),
                "rewards": self._rewards[:n].clone()}

    def load_state_dict(self, state: dict) -> None:
        n = len(state["rewards"])
        for dst, key in zip(self._arrays(), ("states", "actions", "next_states", "rewards")):
            dst[:n].copy_(torch.as_tensor(state[key]))
        self._size = n
        self._head = n % self.capacity
