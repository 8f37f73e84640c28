"""Lower and upper bounds with compression-friendly gradients (PyTorch
counterpart of compression_tpu/ops/math_ops.py:lower_bound / upper_bound)."""

from __future__ import annotations

import torch

__all__ = ["lower_bound", "upper_bound"]

_GRADIENTS = ("disconnected", "identity", "identity_if_towards")


def _as_bound(bound, inputs):
    """``bound`` as a tensor like ``inputs``; a Python number is filled on
    the device (no copy from the host, which would wait for the stream)."""
    if isinstance(bound, torch.Tensor):
        return bound.to(dtype=inputs.dtype, device=inputs.device)
    return torch.full((), float(bound), dtype=inputs.dtype,
                      device=inputs.device)


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


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        return torch.minimum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None
        pass_through = inputs <= bound
        if ctx.gradient == "identity_if_towards":
            pass_through = pass_through | (grad > 0)
        return pass_through.to(grad.dtype) * grad, None, None


def lower_bound(inputs, bound, gradient="identity_if_towards"):
    """torch.maximum with a compression-friendly gradient at the bound:
    'disconnected' (plain max), 'identity' (passes through) or
    'identity_if_towards' (passes only when descent pushes toward the
    bound, the GDN reparameterization's choice)."""
    if gradient not in _GRADIENTS:
        raise ValueError(f"Invalid value for `gradient`: '{gradient}'.")
    bound = _as_bound(bound, inputs)
    return _LowerBound.apply(inputs, bound, gradient)


def upper_bound(inputs, bound, gradient="identity_if_towards"):
    """torch.minimum with the mirrored gradient choices of
    ``lower_bound``: 'identity_if_towards' passes the gradient only when
    descent pushes the input toward the bound."""
    if gradient not in _GRADIENTS:
        raise ValueError(f"Invalid value for `gradient`: '{gradient}'.")
    bound = _as_bound(bound, inputs)
    return _UpperBound.apply(inputs, bound, gradient)
