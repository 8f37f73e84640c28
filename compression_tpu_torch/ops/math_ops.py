"""Lower bound with a compression-friendly gradient (PyTorch counterpart of
compression_tpu/ops/math_ops.py:lower_bound)."""

from __future__ import annotations

import torch

__all__ = ["lower_bound"]

_GRADIENTS = ("disconnected", "identity", "identity_if_towards")


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        return torch.maximum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None
        pass_through = inputs >= bound
        if ctx.gradient == "identity_if_towards":
            pass_through = pass_through | (grad < 0)
        return pass_through.to(grad.dtype) * grad, None, None


def lower_bound(inputs, bound, gradient="identity_if_towards"):
    """torch.maximum with a compression-friendly gradient at the bound:
    'disconnected' (plain max), 'identity' (passes through) or
    'identity_if_towards' (passes only when descent pushes toward the
    bound, the GDN reparameterization's choice)."""
    if gradient not in _GRADIENTS:
        raise ValueError(f"Invalid value for `gradient`: '{gradient}'.")
    bound = torch.as_tensor(bound, dtype=inputs.dtype, device=inputs.device)
    return _LowerBound.apply(inputs, bound, gradient)
