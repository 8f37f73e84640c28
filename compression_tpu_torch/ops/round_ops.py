"""Straight-through rounding (PyTorch counterpart of
compression_tpu/ops/round_ops.py:round_st)."""

from __future__ import annotations

import torch

__all__ = ["round_st"]


class _RoundST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, offset):
        if offset is None:
            return torch.round(inputs)
        return torch.round(inputs - offset) + offset

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def round_st(inputs, offset=None):
    """Rounds half to even (around ``offset`` when given) with an identity
    gradient for ``inputs`` and none for ``offset``."""
    return _RoundST.apply(inputs, offset)
