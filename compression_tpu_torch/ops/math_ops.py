"""Math operations with compression-specific gradients (PyTorch
counterpart of compression_tpu/ops/math_ops.py): ``lower_bound`` /
``upper_bound`` (max / min with 'identity', 'identity_if_towards' or
'disconnected' gradients) and ``perturb_and_apply`` (additive U(-.5, .5)
noise with the analytically expected gradient, Agustsson & Theis 2020
§4.2), and ``parameter_gradient_reduction``, where the data-parallel train
steps reduce a parameter's gradient before a bound's gate."""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["lower_bound", "upper_bound", "perturb_and_apply",
           "parameter_gradient_reduction"]

_GRADIENTS = ("disconnected", "identity", "identity_if_towards")
# The reduction ``parameter_gradient_reduction`` sets, per thread.
_REDUCTION = threading.local()


@contextlib.contextmanager
def parameter_gradient_reduction(reduce):
    """While active, ``lower_bound`` / ``upper_bound`` with the
    'identity_if_towards' gradient, applied to a leaf tensor that requires
    grad (a parameter, e.g. GDN's reparameterized beta and gamma), pass
    the gradient they receive through ``reduce`` before their gate, which
    depends on its sign.  The data-parallel train steps average it over
    the data group there, so that the gate sees the global batch's
    gradient, as one process's step does; gated on each rank's own
    gradient, the averaged result would differ wherever the ranks' signs
    differ.  The function is bound when the op runs forward."""
    saved = getattr(_REDUCTION, "fn", None)
    _REDUCTION.fn = reduce
    try:
        yield
    finally:
        _REDUCTION.fn = saved


def _reduction(inputs, gradient):
    if gradient == "identity_if_towards" and inputs.is_leaf \
            and inputs.requires_grad:
        return getattr(_REDUCTION, "fn", None)
    return None


def _as_bound(bound, inputs):
    """``bound`` as a tensor like ``inputs``; a Python number is filled on
    the device (no copy from the host, which would wait for the stream)."""
    if isinstance(bound, torch.Tensor):
        return bound.to(dtype=inputs.dtype, device=inputs.device)
    return torch.full((), float(bound), dtype=inputs.dtype,
                      device=inputs.device)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient, reduce):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        ctx.reduce = reduce
        return torch.maximum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None, None
        if ctx.reduce is not None:
            grad = ctx.reduce(grad)
        pass_through = inputs >= bound
        if ctx.gradient == "identity_if_towards":
            pass_through = pass_through | (grad < 0)
        return pass_through.to(grad.dtype) * grad, None, None, None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient, reduce):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        ctx.reduce = reduce
        return torch.minimum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None, None
        if ctx.reduce is not None:
            grad = ctx.reduce(grad)
        pass_through = inputs <= bound
        if ctx.gradient == "identity_if_towards":
            pass_through = pass_through | (grad > 0)
        return pass_through.to(grad.dtype) * grad, None, None, None


def lower_bound(inputs, bound, gradient="identity_if_towards"):
    """torch.maximum with a compression-friendly gradient at the bound:
    'disconnected' (plain max), 'identity' (passes through) or
    'identity_if_towards' (passes only when descent pushes toward the
    bound, the GDN reparameterization's choice)."""
    if gradient not in _GRADIENTS:
        raise ValueError(f"Invalid value for `gradient`: '{gradient}'.")
    bound = _as_bound(bound, inputs)
    return _LowerBound.apply(inputs, bound, gradient,
                             _reduction(inputs, gradient))


def upper_bound(inputs, bound, gradient="identity_if_towards"):
    """torch.minimum with the mirrored gradient choices of
    ``lower_bound``: 'identity_if_towards' passes the gradient only when
    descent pushes the input toward the bound."""
    if gradient not in _GRADIENTS:
        raise ValueError(f"Invalid value for `gradient`: '{gradient}'.")
    bound = _as_bound(bound, inputs)
    return _UpperBound.apply(inputs, bound, gradient,
                             _reduction(inputs, gradient))


class _ExpectedGrads(torch.autograd.Function):
    """Passes ``y`` on unchanged and gives ``x`` the gradient
    ``grad * dydx`` (``dydx`` a constant, like the JAX package's residual)."""

    @staticmethod
    def forward(ctx, y, x, dydx):
        ctx.save_for_backward(dydx)
        return y.clone()

    @staticmethod
    def backward(ctx, grad):
        (dydx,) = ctx.saved_tensors
        return grad, grad * dydx, None


def perturb_and_apply(f, x, *args, generator=None, u=None, x_plus_u=None,
                      expected_grads=True):
    """Perturbs ``x`` with U(-.5, .5) noise and applies the pointwise ``f``.

    Returns ``(f(x + u, *args), x + u)``.  With ``expected_grads=True`` the
    gradient of the first result with respect to ``x`` is the analytically
    expected derivative over the noise, ``f(x + .5) - f(x - .5)`` (taken as
    a constant: it is not differentiated with respect to ``args``), and
    ``args`` (and whatever ``f`` closes over) get their ordinary gradient
    at ``x + u``.  Without it every gradient is the ordinary one.  The
    returned ``x + u`` carries the identity gradient to ``x``.

    Exactly one noise source: ``generator`` (a ``torch.Generator`` on
    ``x``'s device, which draws the noise there), ``u`` or ``x_plus_u``.
    """
    if x_plus_u is None:
        if u is None:
            if generator is None:
                raise ValueError(
                    "Provide one of `generator`, `u`, or `x_plus_u`.")
            if generator.device.type != x.device.type or (
                    x.device.index is not None
                    and generator.device.index not in (None, x.device.index)):
                raise ValueError(
                    f"the generator lies on {generator.device}, the tensor "
                    f"on {x.device}: the noise is drawn where the tensor "
                    "lies")
            u = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            u.uniform_(-0.5, 0.5, generator=generator)
        x_plus_u = x + u
    elif u is not None or generator is not None:
        raise ValueError("Cannot provide both `x_plus_u` and `u`/`generator`.")

    if not expected_grads:
        return f(x_plus_u, *args), x_plus_u
    y = f(x_plus_u.detach(), *args)
    with torch.no_grad():
        dydx = f(x + 0.5, *args) - f(x - 0.5, *args)
    return _ExpectedGrads.apply(y, x, dydx), x_plus_u
