"""Scalar distribution protocol (PyTorch counterpart of
compression_tpu/distributions/base.py:Distribution).

Distributions are plain Python objects over tensors.  The duck-typed
protocol consumed by ``helpers.{quantization_offset, lower_tail,
upper_tail}`` mirrors the reference (python/distributions/helpers.py):
a distribution may implement ``_quantization_offset() / _lower_tail(m) /
_upper_tail(m)`` and the usual ``log_cdf / quantile / mode / mean``;
NotImplementedError walks the fallback chains.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Distribution", "Normal"]


class Distribution:
    """Base class: scalar distribution with a batch shape."""

    dtype = torch.float32

    @property
    def batch_shape(self):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def prob(self, x):
        return torch.exp(self.log_prob(x))

    def log_cdf(self, x):
        raise NotImplementedError

    def cdf(self, x):
        return torch.exp(self.log_cdf(x))

    def log_survival_function(self, x):
        raise NotImplementedError

    def survival_function(self, x):
        return torch.exp(self.log_survival_function(x))

    def quantile(self, p):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def mode(self):
        raise NotImplementedError


class Normal(Distribution):
    """Gaussian; loc / scale broadcast to the batch shape (counterpart of
    compression_tpu/distributions/base.py:Normal)."""

    def __init__(self, loc, scale):
        self.scale = torch.as_tensor(scale)
        if not self.scale.is_floating_point():
            self.scale = self.scale.to(torch.float32)
        self.loc = torch.as_tensor(loc, dtype=self.scale.dtype,
                                   device=self.scale.device)
        self.dtype = self.scale.dtype

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def _std(self, x):
        return (x - self.loc) / self.scale

    def log_prob(self, x):
        z = self._std(x)
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * math.log(
            2 * math.pi)

    def log_cdf(self, x):
        return torch.special.log_ndtr(self._std(x))

    def log_survival_function(self, x):
        return torch.special.log_ndtr(-self._std(x))

    def cdf(self, x):
        return torch.special.ndtr(self._std(x))

    def survival_function(self, x):
        return torch.special.ndtr(-self._std(x))

    def quantile(self, p):
        p = torch.as_tensor(p, dtype=self.dtype, device=self.scale.device)
        return self.loc + self.scale * torch.special.ndtri(p)

    def mean(self):
        return self.loc.expand(self.batch_shape)

    def mode(self):
        return self.mean()
