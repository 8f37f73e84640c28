"""Kernel initializers (PyTorch counterpart of
compression_tpu/layers/initializers.py; reference
python/layers/initializers.py:25-55)."""

from __future__ import annotations

import torch

__all__ = ["identity_initializer"]


def identity_initializer(gain=1.0):
    """n-D Dirac kernel initializer for SignalConv.

    Returns ``init(shape, dtype=torch.float32)``: a kernel in the JAX layout
    [spatial..., in, out] that (away from boundaries) passes its input
    through unchanged -- a spatial delta at the kernel center times the
    channel identity.
    """

    def init(shape, dtype=torch.float32):
        shape = tuple(int(s) for s in shape)
        if len(shape) <= 2:
            raise ValueError(f"shape must be at least rank 3, got {shape}.")
        support = shape[:-2]
        spatial = torch.zeros(support + (1, 1), dtype=dtype)
        spatial[tuple(s // 2 for s in support) + (0, 0)] = gain
        return spatial * torch.eye(shape[-2], shape[-1], dtype=dtype)

    return init
