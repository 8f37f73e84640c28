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

import torch

__all__ = ["Distribution"]


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
