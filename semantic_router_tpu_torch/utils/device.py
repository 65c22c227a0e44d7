"""Device resolution for the port's entry points.

Every entry point serves on the GPU unless its caller names another device.
Without a visible CUDA device and without an explicit ``device``, it raises:
the port never carries on on the host in silence.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device is visible); anything
    else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
