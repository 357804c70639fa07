"""Synthetic data source made on the device.

Port of ``multimodal_active_ai_tpu/data/synthetic.py``: deterministic
uint8 image batches and labels drawn from a seeded ``torch.Generator`` on
the target device, so the compute path runs without a dataset and without
host-to-device copies. ``reset()`` restarts the same stream.
"""

from __future__ import annotations

import torch


class SyntheticReader:
    """Fake ``(B, S, S, 3)`` uint8 images and ``(B,)`` int64 labels."""

    def __init__(self, batch_size: int, canvas_size: int, num_examples: int = 12800,
                 num_classes: int = 1000, seed: int = 15,
                 device: torch.device | str = "cpu"):
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.num_examples = num_examples
        self.num_classes = num_classes
        self.seed = seed
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self.reset()

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if self._i * self.batch_size >= self.num_examples:
            raise StopIteration
        s = self.canvas_size
        images = torch.randint(0, 256, (self.batch_size, s, s, 3), generator=self._gen,
                               dtype=torch.uint8, device=self.device)
        labels = torch.randint(0, self.num_classes, (self.batch_size,),
                               generator=self._gen, device=self.device)
        self._i += 1
        return images, labels

    def reset(self):
        """Restart the stream (DALI ``pipe.reset()`` parity)."""
        self._i = 0
        self._gen.manual_seed(self.seed)

    def __len__(self):
        return -(-self.num_examples // self.batch_size)
