"""Projection head, linear probe, Identity.

Port of ``multimodal_active_ai_tpu/models/mlp.py``. The JAX ``MLP``
flattens an NHWC feature map; this one flattens C-major (the NCHW order of
the reference torch module), so its ``g.layers.0.weight`` is the reference
checkpoint's. ``utils.checkpoint.from_jax_variables`` permutes JAX weights
into that order.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def dense_init_(linear: nn.Linear, generator: torch.Generator | None = None) -> None:
    """flax ``Dense`` defaults: lecun-normal kernel (fan_in, truncated at
    ±2σ), zero bias."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        linear.bias.zero_()


def _flatten_c_major(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` → ``(B, C·H·W)`` in C-major order; other shapes
    flatten as they are."""
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    return x.reshape(x.shape[0], -1)


class MLP(nn.Module):
    """Flatten → Linear(hidden) → ReLU → Linear(out), as ``layers.0/1/2``
    (reference ``multilayerPerceptron.py:9-22``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(input_dim, hidden_dim), nn.ReLU(),
                                    nn.Linear(hidden_dim, output_dim))
        dense_init_(self.layers[0], generator)
        dense_init_(self.layers[2], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(_flatten_c_major(x))


class LogisticRegression(nn.Module):
    """Single linear classifier (reference ``multivariateLogisticRegression.py``)."""

    def __init__(self, input_dim: int, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear = nn.Linear(input_dim, num_classes)
        dense_init_(self.linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(_flatten_c_major(x))


class Identity(nn.Module):
    """Pass-through (reference ``Model_Util.py:122-127``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
