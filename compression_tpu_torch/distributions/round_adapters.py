"""Distribution adapters for (soft-)rounded random variables (PyTorch
counterpart of compression_tpu/distributions/round_adapters.py; the
reference's python/distributions/round_adapters.py, Agustsson & Theis
2020, appendix E): a monotonic transform adapter whose CDF is
base.cdf(inverse_transform(y)), specialized to hard round (inverse
``ceil(y) - .5``) and soft round.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.distributions import base as base_lib
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.ops import round_ops

__all__ = [
    "MonotonicAdapter",
    "RoundAdapter",
    "NoisyRoundAdapter",
    "NoisyRoundedNormal",
    "NoisyRoundedDeepFactorized",
    "SoftRoundAdapter",
    "NoisySoftRoundAdapter",
    "NoisySoftRoundedNormal",
    "NoisySoftRoundedDeepFactorized",
]


class MonotonicAdapter(base_lib.Distribution):
    """Adapts a continuous distribution through an ascending monotonic
    map."""

    invertible = True

    def __init__(self, base):
        self.base = base
        self.dtype = base.dtype

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def transform(self, x):
        raise NotImplementedError

    def inverse_transform(self, y):
        # g(y) := inf_x { x : f(x) >= y }; the inverse when f is invertible.
        raise NotImplementedError

    # P(f(x) <= y) = P(x <= g(y)).
    def cdf(self, y):
        return self.base.cdf(self.inverse_transform(y))

    def log_cdf(self, y):
        return self.base.log_cdf(self.inverse_transform(y))

    def survival_function(self, y):
        return self.base.survival_function(self.inverse_transform(y))

    def log_survival_function(self, y):
        return self.base.log_survival_function(self.inverse_transform(y))

    def quantile(self, value):
        if not self.invertible:
            raise NotImplementedError
        return self.transform(self.base.quantile(value))

    def mode(self):
        if not self.invertible:
            raise NotImplementedError
        return self.transform(self.base.mode())

    def _quantization_offset(self):
        if not self.invertible:
            raise NotImplementedError
        return self.transform(helpers.quantization_offset(self.base))

    def _lower_tail(self, tail_mass):
        if not self.invertible:
            raise NotImplementedError
        return self.transform(helpers.lower_tail(self.base, tail_mass))

    def _upper_tail(self, tail_mass):
        if not self.invertible:
            raise NotImplementedError
        return self.transform(helpers.upper_tail(self.base, tail_mass))


class RoundAdapter(MonotonicAdapter):
    """Continuous density + hard round."""

    invertible = False

    def transform(self, x):
        return torch.round(x)

    def inverse_transform(self, y):
        return torch.ceil(y) - 0.5

    def _quantization_offset(self):
        return torch.zeros((), dtype=self.dtype)

    def _lower_tail(self, tail_mass):
        return torch.floor(helpers.lower_tail(self.base, tail_mass))

    def _upper_tail(self, tail_mass):
        return torch.ceil(helpers.upper_tail(self.base, tail_mass))


class NoisyRoundAdapter(uniform_noise.UniformNoiseAdapter):
    """Round + uniform noise."""

    def __init__(self, base):
        super().__init__(RoundAdapter(base))


class NoisyRoundedNormal(NoisyRoundAdapter):
    def __init__(self, **kwargs):
        super().__init__(base_lib.Normal(**kwargs))


class NoisyRoundedDeepFactorized(NoisyRoundAdapter):
    def __init__(self, **kwargs):
        super().__init__(deep_factorized.DeepFactorized(**kwargs))


class SoftRoundAdapter(MonotonicAdapter):
    """Differentiable approximation to round."""

    def __init__(self, base, alpha):
        super().__init__(base)
        self.alpha = alpha

    def transform(self, x):
        return round_ops.soft_round(x, self.alpha)

    def inverse_transform(self, y):
        return round_ops.soft_round_inverse(y, self.alpha)


class NoisySoftRoundAdapter(uniform_noise.UniformNoiseAdapter):
    def __init__(self, base, alpha):
        super().__init__(SoftRoundAdapter(base, alpha))


class NoisySoftRoundedNormal(NoisySoftRoundAdapter):
    def __init__(self, alpha=5.0, **kwargs):
        super().__init__(base_lib.Normal(**kwargs), alpha)


class NoisySoftRoundedDeepFactorized(NoisySoftRoundAdapter):
    def __init__(self, alpha=5.0, **kwargs):
        super().__init__(deep_factorized.DeepFactorized(**kwargs), alpha)
