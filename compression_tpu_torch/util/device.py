"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises when CUDA is asked for and
    absent.  Entry points run on the card unless the caller passes
    device="cpu": nothing falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU.")
    return device
