"""Soft-round layers (PyTorch counterpart of
compression_tpu/layers/soft_round.py; the reference's
python/layers/soft_round.py:27-56)."""

from __future__ import annotations

from torch import nn

from compression_tpu_torch.ops import round_ops

__all__ = ["SoftRound", "SoftRoundConditionalMean"]


class SoftRound(nn.Module):
    """Differentiable approximation of rounding (or its inverse)."""

    def __init__(self, alpha=5.0, inverse=False):
        super().__init__()
        self.alpha = alpha
        self.inverse = inverse

    def forward(self, inputs):
        fn = (round_ops.soft_round_inverse if self.inverse
              else round_ops.soft_round)
        return fn(inputs, self.alpha)


class SoftRoundConditionalMean(nn.Module):
    """Conditional mean of inputs given noisy soft-rounded values."""

    def __init__(self, alpha=5.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, inputs):
        return round_ops.soft_round_conditional_mean(inputs, self.alpha)
