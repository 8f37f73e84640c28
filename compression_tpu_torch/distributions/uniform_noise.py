"""Uniform noise adapter and the Noisy* distribution family (PyTorch
counterpart of compression_tpu/distributions/uniform_noise.py).

The adapter convolves a base density with a unit-width box,
``(p * u)(x) = c(x+.5) - c(x-.5)``, evaluated stably from log-CDF /
log-survival pairs with the exp-big-minus-exp-small trick.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.distributions import base as base_lib
from compression_tpu_torch.distributions import helpers

__all__ = [
    "UniformNoiseAdapter",
    "NoisyNormal",
    "NoisyLogistic",
    "NoisyLaplace",
    "NoisyMixtureSameFamily",
    "NoisyNormalMixture",
    "NoisyLogisticMixture",
]


def _logsum_expbig_minus_expsmall(big, small):
    """Stable log(exp(big) - exp(small)) for small <= big."""
    return torch.where(
        torch.isinf(big), big, torch.log1p(-torch.exp(small - big)) + big)


class UniformNoiseAdapter(base_lib.Distribution):
    """Models base + U(-.5, .5) (additive i.i.d. uniform noise)."""

    def __init__(self, base):
        self.base = base
        self.dtype = base.dtype

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def log_prob(self, y):
        # Prefer the sf+cdf path (precise on both sides of the median).
        try:
            return self._log_prob_with_logsf_and_logcdf(y)
        except NotImplementedError:
            return self._log_prob_with_logcdf(y)

    def _log_prob_with_logcdf(self, y):
        return _logsum_expbig_minus_expsmall(
            self.base.log_cdf(y + 0.5), self.base.log_cdf(y - 0.5))

    def _log_prob_with_logsf_and_logcdf(self, y):
        # The survival function is precise right of the median, where the
        # CDF saturates.
        logsf_y_plus = self.base.log_survival_function(y + 0.5)
        logsf_y_minus = self.base.log_survival_function(y - 0.5)
        logcdf_y_plus = self.base.log_cdf(y + 0.5)
        logcdf_y_minus = self.base.log_cdf(y - 0.5)
        condition = logsf_y_plus < logcdf_y_plus
        big = torch.where(condition, logsf_y_minus, logcdf_y_plus)
        small = torch.where(condition, logsf_y_plus, logcdf_y_minus)
        return _logsum_expbig_minus_expsmall(big, small)

    def prob(self, y):
        try:
            return self._prob_with_sf_and_cdf(y)
        except NotImplementedError:
            return self._prob_with_cdf(y)

    def _prob_with_cdf(self, y):
        return self.base.cdf(y + 0.5) - self.base.cdf(y - 0.5)

    def _prob_with_sf_and_cdf(self, y):
        sf_y_plus = self.base.survival_function(y + 0.5)
        sf_y_minus = self.base.survival_function(y - 0.5)
        cdf_y_plus = self.base.cdf(y + 0.5)
        cdf_y_minus = self.base.cdf(y - 0.5)
        return torch.where(
            sf_y_plus < cdf_y_plus,
            sf_y_minus - sf_y_plus, cdf_y_plus - cdf_y_minus)

    def mean(self):
        return self.base.mean()

    def _quantization_offset(self):
        return helpers.quantization_offset(self.base)

    def _lower_tail(self, tail_mass):
        return helpers.lower_tail(self.base, tail_mass)

    def _upper_tail(self, tail_mass):
        return helpers.upper_tail(self.base, tail_mass)


class NoisyNormal(UniformNoiseAdapter):
    """Normal(loc, scale) + U(-.5, .5)."""

    def __init__(self, **kwargs):
        super().__init__(base_lib.Normal(**kwargs))


class NoisyLogistic(UniformNoiseAdapter):
    """Logistic(loc, scale) + U(-.5, .5)."""

    def __init__(self, **kwargs):
        super().__init__(base_lib.Logistic(**kwargs))


class NoisyLaplace(UniformNoiseAdapter):
    """Laplace(loc, scale) + U(-.5, .5)."""

    def __init__(self, **kwargs):
        super().__init__(base_lib.Laplace(**kwargs))


class NoisyMixtureSameFamily(base_lib.MixtureSameFamily):
    """Mixture whose components carry additive uniform noise."""

    def __init__(self, mixture_distribution, components_distribution):
        super().__init__(
            mixture_distribution=mixture_distribution,
            components_distribution=UniformNoiseAdapter(
                components_distribution))
        self.base = base_lib.MixtureSameFamily(
            mixture_distribution=mixture_distribution,
            components_distribution=components_distribution)

    def _quantization_offset(self):
        # The "peakiest" of the component quantization offsets (reference
        # uniform_noise.py:237-243): the one where the mixture's density is
        # largest.
        offsets = helpers.quantization_offset(self.components)
        lp = self.log_prob(torch.movedim(offsets, -1, 0))
        component = torch.argmax(lp, dim=0)
        return torch.take_along_dim(offsets, component[..., None],
                                    dim=-1)[..., 0]

    def _lower_tail(self, tail_mass):
        return helpers.lower_tail(self.base, tail_mass)

    def _upper_tail(self, tail_mass):
        return helpers.upper_tail(self.base, tail_mass)


class NoisyNormalMixture(NoisyMixtureSameFamily):
    """Mixture of Normals (weights over the last axis) + U(-.5, .5)."""

    def __init__(self, loc, scale, weight):
        super().__init__(
            mixture_distribution=base_lib.Categorical(probs=weight),
            components_distribution=base_lib.Normal(loc=loc, scale=scale))


class NoisyLogisticMixture(NoisyMixtureSameFamily):
    """Mixture of Logistics (weights over the last axis) + U(-.5, .5)."""

    def __init__(self, loc, scale, weight):
        super().__init__(
            mixture_distribution=base_lib.Categorical(probs=weight),
            components_distribution=base_lib.Logistic(loc=loc, scale=scale))
