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
import torch.nn.functional as F

__all__ = ["Distribution", "Normal", "Logistic", "Laplace", "Categorical",
           "MixtureSameFamily"]


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


def _ndtr(x):
    """The standard normal CDF, precise in both tails: erf near 0, erfc
    beyond (cephes' ndtr, which jax.scipy.special.ndtr computes;
    torch.special.ndtr in float32 loses the left tail to 1 + erf, e.g.
    2**-24 at x = -5.33 where the CDF is 4.8e-8)."""
    x = x * math.sqrt(0.5)
    z = torch.abs(x)
    return torch.where(
        z < math.sqrt(0.5), 0.5 + 0.5 * torch.erf(x),
        torch.where(x > 0, 1.0 - 0.5 * torch.erfc(z), 0.5 * torch.erfc(z)))


class _LocationScale(Distribution):
    """loc / scale broadcast to the batch shape, as ``Normal`` holds them."""

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

    def _p(self, p):
        return torch.as_tensor(p, dtype=self.dtype, device=self.scale.device)

    def mean(self):
        return self.loc.expand(self.batch_shape)

    def mode(self):
        return self.mean()


class Normal(_LocationScale):
    """Gaussian; loc / scale broadcast to the batch shape (counterpart of
    compression_tpu/distributions/base.py:Normal)."""

    def log_prob(self, x):
        z = self._std(x)
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * math.log(
            2 * math.pi)

    def log_cdf(self, x):
        return torch.special.log_ndtr(self._std(x))

    def log_survival_function(self, x):
        return torch.special.log_ndtr(-self._std(x))

    def cdf(self, x):
        return _ndtr(self._std(x))

    def survival_function(self, x):
        return _ndtr(-self._std(x))

    def quantile(self, p):
        return self.loc + self.scale * torch.special.ndtri(self._p(p))


class Logistic(_LocationScale):
    """Logistic(loc, scale) (counterpart of
    compression_tpu/distributions/base.py:Logistic)."""

    def log_prob(self, x):
        z = self._std(x)
        return -z - 2 * F.softplus(-z) - torch.log(self.scale)

    def log_cdf(self, x):
        return F.logsigmoid(self._std(x))

    def log_survival_function(self, x):
        return F.logsigmoid(-self._std(x))

    def quantile(self, p):
        p = self._p(p)
        return self.loc + self.scale * (torch.log(p) - torch.log1p(-p))


class Laplace(_LocationScale):
    """Laplace(loc, scale) (counterpart of
    compression_tpu/distributions/base.py:Laplace)."""

    def log_prob(self, x):
        z = torch.abs(x - self.loc) / self.scale
        return -z - torch.log(2 * self.scale)

    def log_cdf(self, x):
        z = self._std(x)
        return torch.where(z <= 0, z - math.log(2.0),
                           torch.log1p(-0.5 * torch.exp(-torch.abs(z))))

    def log_survival_function(self, x):
        z = self._std(x)
        return torch.where(z >= 0, -z - math.log(2.0),
                           torch.log1p(-0.5 * torch.exp(-torch.abs(z))))

    def quantile(self, p):
        p = self._p(p)
        return self.loc - self.scale * torch.sign(p - 0.5) * torch.log1p(
            -2 * torch.abs(p - 0.5))


class Categorical:
    """Categorical over the last axis (mixture weights)."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs/logits.")
        if probs is not None:
            self.logits = torch.log(torch.as_tensor(probs))
        else:
            self.logits = torch.as_tensor(logits)

    def log_probs(self):
        return torch.log_softmax(self.logits, dim=-1)


class MixtureSameFamily(Distribution):
    """Mixture of a batched component family along its last batch axis
    (counterpart of compression_tpu/distributions/base.py:
    MixtureSameFamily)."""

    def __init__(self, mixture_distribution, components_distribution):
        self.mixture = mixture_distribution
        self.components = components_distribution
        self.dtype = components_distribution.dtype

    @property
    def batch_shape(self):
        return tuple(self.components.batch_shape[:-1])

    def _mix(self, per_component):
        return torch.logsumexp(per_component + self.mixture.log_probs(),
                               dim=-1)

    def log_prob(self, x):
        return self._mix(self.components.log_prob(x[..., None]))

    def log_cdf(self, x):
        return self._mix(self.components.log_cdf(x[..., None]))

    def log_survival_function(self, x):
        return self._mix(self.components.log_survival_function(x[..., None]))

    def mean(self):
        w = torch.exp(self.mixture.log_probs())
        return torch.sum(w * self.components.mean(), dim=-1)
