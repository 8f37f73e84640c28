"""Tail/offset estimation helpers for range coding (PyTorch counterpart of
compression_tpu/distributions/helpers.py).

``estimate_tails`` is the reference's vectorized Adam-like fixed-point
iteration (python/distributions/helpers.py:29-101); ``quantization_offset``
/ ``lower_tail`` / ``upper_tail`` walk the same duck-typed fallback chains.
"""

from __future__ import annotations

import torch

__all__ = [
    "estimate_tails",
    "quantization_offset",
    "lower_tail",
    "upper_tail",
]


def estimate_tails(func, target, shape, dtype=torch.float32, device="cpu"):
    """Finds x (elementwise) such that func(x) == target, via Adam iteration.

    func must be monotonic and elementwise.  Mirrors the reference
    iteration exactly: m/v running averages with halving decay, lr
    0.1/sqrt(count+1), counting starts at the first gradient sign flip,
    stops when max |func(x)-target| <= 1e-8 or all counts reach 100;
    returns the best (lowest-loss) iterate seen.  The gradient is
    torch.autograd.grad of the elementwise sum, which gives elementwise
    derivatives because func is elementwise.
    """
    shape = tuple(int(s) for s in shape)
    kw = dict(dtype=dtype, device=device)
    target = torch.as_tensor(target, **kw)
    big = torch.finfo(dtype).max
    tails = torch.zeros(shape, **kw)
    m = torch.zeros(shape, **kw)
    v = torch.ones(shape, **kw)
    loss = torch.full(shape, big, **kw)
    count = torch.zeros(shape, dtype=torch.int32, device=device)
    best_tails = tails
    best_loss = torch.full(shape, big, **kw)
    while bool(loss.max() > 1e-8) and bool(count.min() < 100):
        t = tails.detach().requires_grad_(True)
        with torch.enable_grad():
            step_loss = torch.abs(func(t) - target)
            (grad,) = torch.autograd.grad(step_loss.sum(), t)
        loss = step_loss.detach()
        better = loss < best_loss
        best_tails = torch.where(better, tails, best_tails)
        best_loss = torch.where(better, loss, best_loss)
        new_m = (m + grad) / 2
        v = (v + torch.square(grad)) / 2
        k = torch.sqrt((count + 1).to(dtype))
        tails = tails - 0.1 * new_m / (k * torch.sqrt(v) + 1e-20)
        count = torch.where((count > 0) | (m * grad < 0), count + 1, count)
        m = new_m
    return best_tails


def _try(fn):
    try:
        return fn()
    except (AttributeError, NotImplementedError):
        return None


def quantization_offset(distribution):
    """Mode-aligned sub-integer quantization offset in [-.5, .5].

    Fallback chain: _quantization_offset -> mode -> quantile(.5) -> mean ->
    0, reduced mod round (reference helpers.py:104-147); no gradient.
    """
    offset = _try(lambda: distribution._quantization_offset())
    if offset is None:
        offset = _try(distribution.mode)
    if offset is None:
        offset = _try(lambda: distribution.quantile(0.5))
    if offset is None:
        offset = _try(distribution.mean)
    if offset is None:
        offset = torch.zeros((), dtype=distribution.dtype)
    offset = torch.as_tensor(offset, dtype=distribution.dtype).detach()
    return offset - torch.round(offset)


def _estimate(log_fn, distribution, tail_mass):
    """Where log_fn(x) = log(tail_mass / 2), by ``estimate_tails``."""
    target = torch.log(torch.tensor(tail_mass / 2, dtype=distribution.dtype))
    return estimate_tails(log_fn, target, distribution.batch_shape,
                          distribution.dtype)


def lower_tail(distribution, tail_mass):
    """Approximate lower tail quantile (reference helpers.py:150-183)."""
    tail = _try(lambda: distribution._lower_tail(tail_mass))
    if tail is None:
        tail = _try(lambda: distribution.quantile(tail_mass / 2))
    if tail is None:
        tail = _estimate(distribution.log_cdf, distribution, tail_mass)
    return torch.as_tensor(tail, dtype=distribution.dtype).detach()


def upper_tail(distribution, tail_mass):
    """Approximate upper tail quantile (reference helpers.py:186-219)."""
    tail = _try(lambda: distribution._upper_tail(tail_mass))
    if tail is None:
        tail = _try(lambda: distribution.quantile(1 - tail_mass / 2))
    if tail is None:
        tail = _estimate(distribution.log_survival_function, distribution,
                         tail_mass)
    return torch.as_tensor(tail, dtype=distribution.dtype).detach()
