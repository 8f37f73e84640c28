"""Deep fully-factorized distribution (PyTorch counterpart of
compression_tpu/distributions/deep_factorized.py).

The CDF is a per-channel monotone MLP (softplus-positive matrices with tanh
factor gates, Ballé et al. 2018 appendix 6.1).  The codec uses it through
NoisyDeepFactorized, which needs only the CDF and survival function.

Parameters are a plain dict of tensor lists (``init_params``), the layout of
the JAX package's pytree: {"matrices": [C,o,i]..., "biases": [C,o,1]...,
"factors": [C,o,1]...}.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from compression_tpu_torch.distributions import base as base_lib
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions import uniform_noise

__all__ = ["DeepFactorized", "NoisyDeepFactorized", "log_expm1"]


def log_expm1(x):
    """log(exp(x) - 1), stable for large x (~= x for x > 15)."""
    x = torch.as_tensor(x)
    return torch.where(x < 15.0, torch.log(torch.expm1(torch.clamp(
        x, max=15.0))), x)


class DeepFactorized(base_lib.Distribution):
    """Non-parametric scalar density via a monotone MLP cumulative."""

    def __init__(self, params, *, batch_shape=(), num_filters=(3, 3),
                 dtype=torch.float32):
        self._batch_shape_tuple = tuple(int(s) for s in batch_shape)
        self.num_filters = tuple(int(f) for f in num_filters)
        self.dtype = dtype
        self.params = params

    @staticmethod
    def init_params(batch_shape, num_filters=(3, 3), init_scale=10.0,
                    dtype=torch.float32, generator=None, device="cpu"):
        """Initializes the matrices/biases/factors (JAX init scheme:
        constant softplus-inverse matrices, U(-.5, .5) biases, zero
        factors), drawing the biases from ``generator``."""
        channels = int(np.prod(batch_shape)) if batch_shape else 1
        filters = (1,) + tuple(num_filters) + (1,)
        scale = init_scale ** (1 / (len(num_filters) + 1))
        matrices, biases, factors = [], [], []
        for i in range(len(num_filters) + 1):
            init = log_expm1(torch.tensor(
                1 / scale / filters[i + 1], dtype=torch.float32)).to(dtype)
            matrices.append(torch.full(
                (channels, filters[i + 1], filters[i]), float(init),
                dtype=dtype, device=device))
            biases.append(torch.rand(
                (channels, filters[i + 1], 1), generator=generator,
                dtype=dtype, device=device) - 0.5)
            if i < len(num_filters):
                factors.append(torch.zeros(
                    (channels, filters[i + 1], 1), dtype=dtype,
                    device=device))
        return {"matrices": matrices, "biases": biases, "factors": factors}

    @property
    def batch_shape(self):
        return self._batch_shape_tuple

    def _channels(self):
        return int(np.prod(self._batch_shape_tuple)) \
            if self._batch_shape_tuple else 1

    def _broadcast_inputs(self, x):
        shape = torch.broadcast_shapes(x.shape, self.batch_shape)
        return x.expand(shape)

    def _logits_cumulative(self, inputs):
        """Logits of the cumulative; elementwise in inputs, monotone."""
        shape = inputs.shape
        c = self._channels()
        logits = inputs.reshape(-1, 1, c).permute(2, 1, 0)  # (C, 1, batch)
        n = len(self.num_filters)
        for i in range(n + 1):
            matrix = F.softplus(self.params["matrices"][i])
            logits = torch.matmul(matrix, logits)
            logits = logits + self.params["biases"][i]
            if i < n:
                factor = torch.tanh(self.params["factors"][i])
                logits = logits + factor * torch.tanh(logits)
        return logits.permute(2, 1, 0).reshape(shape)

    def log_cdf(self, x):
        return F.logsigmoid(self._logits_cumulative(self._broadcast_inputs(x)))

    def log_survival_function(self, x):
        return F.logsigmoid(
            -self._logits_cumulative(self._broadcast_inputs(x)))

    def cdf(self, x):
        return torch.sigmoid(
            self._logits_cumulative(self._broadcast_inputs(x)))

    def survival_function(self, x):
        return torch.sigmoid(
            -self._logits_cumulative(self._broadcast_inputs(x)))

    def _device(self):
        return self.params["matrices"][0].device

    def _quantization_offset(self):
        return helpers.estimate_tails(
            self._logits_cumulative, 0.0, self.batch_shape, self.dtype,
            self._device())

    def _lower_tail(self, tail_mass):
        target = math.log(tail_mass / 2 / (1.0 - tail_mass / 2))
        return helpers.estimate_tails(
            self._logits_cumulative, target, self.batch_shape, self.dtype,
            self._device())

    def _upper_tail(self, tail_mass):
        target = -math.log(tail_mass / 2 / (1.0 - tail_mass / 2))
        return helpers.estimate_tails(
            self._logits_cumulative, target, self.batch_shape, self.dtype,
            self._device())


class NoisyDeepFactorized(uniform_noise.UniformNoiseAdapter):
    """DeepFactorized convolved with unit-width uniform noise."""

    def __init__(self, **kwargs):
        super().__init__(DeepFactorized(**kwargs))
