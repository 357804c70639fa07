"""Device resolution for the port's entry points.

Entry points default to ``cuda`` and never fall back to the CPU on their own:
a run that asked for the card and did not get it would report CPU numbers
under a GPU's name. Library functions take no device argument; they follow
the device of the tensors they are given.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """Map a ``--device`` value to a :class:`torch.device`.

    Raises ``RuntimeError`` when CUDA is requested and unavailable, and
    ``ValueError`` for any other device type.
    """
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; "
                "pass --device cpu to run on the CPU")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
