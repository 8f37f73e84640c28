"""Rounding ops: straight-through round and soft rounding (PyTorch
counterpart of compression_tpu/ops/round_ops.py; Agustsson & Theis 2020,
"Universally Quantized Neural Compression" §4.1)."""

from __future__ import annotations

import torch

__all__ = [
    "round_st",
    "soft_round",
    "soft_round_inverse",
    "soft_round_conditional_mean",
]


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


def _alpha(alpha, like):
    return torch.as_tensor(alpha, dtype=like.dtype, device=like.device)


def soft_round(x, alpha, eps=1e-3):
    """Differentiable approximation to round; the identity for
    alpha < eps."""
    alpha = _alpha(alpha, x)
    alpha_bounded = torch.clamp_min(alpha, eps)
    m = torch.floor(x) + 0.5
    z = torch.tanh(alpha_bounded / 2.0) * 2.0
    y = m + torch.tanh(alpha_bounded * (x - m)) / z
    return torch.where(alpha < eps, x, y)


def soft_round_inverse(y, alpha, eps=1e-3):
    """Inverse of soft_round; the identity for alpha < eps."""
    alpha = _alpha(alpha, y)
    alpha_bounded = torch.clamp_min(alpha, eps)
    m = torch.floor(y) + 0.5
    s = (y - m) * (torch.tanh(alpha_bounded / 2.0) * 2.0)
    # jnp.clip's form: at the bound itself the gradient is halved.
    r = torch.minimum(torch.maximum(torch.atanh(s) / alpha_bounded,
                                    _alpha(-0.5, y)), _alpha(0.5, y))
    return torch.where(alpha < eps, y, m + r)


def soft_round_conditional_mean(y, alpha):
    """E[Y | s(Y) + U = y] for the soft-rounding quantizer."""
    return soft_round_inverse(y - 0.5, alpha) + 0.5
