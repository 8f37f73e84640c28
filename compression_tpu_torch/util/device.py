"""Device selection for the port's entry points, and the host code's
inputs."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "host_array", "code_units", "decoded_tensor"]


def resolve_device(device="cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises when CUDA is asked for and
    absent.  Entry points run on the card unless the caller passes
    device="cpu": nothing falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU.")
    return device


def host_array(x, what: str, dtype=None):
    """``x`` (numpy, a sequence or a CPU tensor) as a numpy array, for host
    code.  A CUDA tensor raises: its work stays on the card unless the
    caller moves it with ``.cpu()`` and so sees the copy."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"{what} runs on the host and takes numpy arrays or CPU "
                f"tensors; got a tensor on {x.device}. Pass x.cpu() to "
                "copy it to the host.")
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        x = x.numpy()
    return np.asarray(x, dtype)


def code_units(bottleneck, coding_rank, what: str):
    """The rounded bottleneck as int32 numpy rows, one a coding unit of the
    last ``coding_rank`` axes (host code, as ``host_array``)."""
    bottleneck = host_array(bottleneck, what)
    unit = int(np.prod(bottleneck.shape[bottleneck.ndim - coding_rank:])) \
        if coding_rank else 1
    return np.round(bottleneck).astype(np.int32).reshape(-1, unit)


def decoded_tensor(rows, dtype, device):
    """Stacked decoded rows as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.stack(rows)).to(
        device=resolve_device(device), dtype=dtype)
