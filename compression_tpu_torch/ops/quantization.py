"""Stochastic rounding (PyTorch counterpart of
compression_tpu/ops/quantization.py; reference
cc/kernels/quantization_kernels.cc:48-108).

Two seeding modes:
  * ``stochastic_round(..., generator=...)`` runs on the inputs' device:
    ``floor(x / step) + Bernoulli(frac)`` with one 24-bit uniform per
    element, taken as ``bits >> 8`` of a 32-bit draw from a
    ``torch.Generator`` (the JAX package takes the same bits from
    ``jax.random.bits``; ``_stochastic_round_bits`` takes them given, so
    that both packages round alike on the same bits).
  * ``stochastic_round_reference(..., seed=[...])`` is the bit-exact
    replica of the reference CPU op: std::seed_seq-seeded xoshiro256+
    (util/xoshiro.py), one 24-bit uniform per element in C-flat order,
    float32 comparisons.  Host code, numpy in and out.
"""

from __future__ import annotations

import numpy as np
import torch

from compression_tpu_torch.util import xoshiro
from compression_tpu_torch.util.device import host_array

__all__ = ["stochastic_round", "stochastic_round_reference"]


def _stochastic_round_bits(inputs, step_size, bits):
    """Rounds ``inputs / step_size`` up where ``(bits >> 8) * 2^-24`` is
    below its fraction; ``bits`` are 32-bit draws (any integer tensor of
    the inputs' shape and device, read modulo 2^32)."""
    x = inputs.to(torch.float32)
    # A 0-d tensor on the inputs' device: a true division, as XLA's (CUDA
    # divides by a host scalar through its reciprocal).
    x = x / torch.tensor(step_size, dtype=torch.float32, device=x.device)
    integral = torch.floor(x)
    fractional = x - integral
    bits = bits.to(torch.int64) & 0xFFFFFFFF
    random = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return (integral + (random < fractional).to(torch.float32)).to(
        torch.int32)


def stochastic_round(inputs, step_size, generator=None):
    """Rounds inputs / step_size stochastically to int32, on the inputs'
    device.

    Args:
      inputs: floating point tensor (f32 / bf16 / f16).
      step_size: scalar step.
      generator: ``torch.Generator`` on the inputs' device (the explicit
        analog of the op's ``seed`` input); None draws from the device's
        default generator.

    Returns:
      int32 tensor of the same shape and device.
    """
    bits = torch.randint(0, 2 ** 32, inputs.shape, generator=generator,
                         dtype=torch.int64, device=inputs.device)
    return _stochastic_round_bits(inputs, step_size, bits)


def stochastic_round_reference(inputs, step_size, seed):
    """Bit-exact replica of the reference StochasticRound CPU kernel.

    Reference cc/kernels/quantization_kernels.cc:53-95: inputs are
    promoted to float32, divided by ``step_size``, floored; the fraction is
    compared against a seeded xoshiro256+ 24-bit uniform drawn per element
    in flat order.

    Args:
      inputs: float array or CPU tensor (f32 / bf16 / f16, promoted to f32
        like the op); a CUDA tensor raises.
      step_size: scalar step.
      seed: sequence of int32 seed values (non-empty: the reference's
        unseeded mode draws from the system clock and cannot be
        reproduced).

    Returns:
      int32 numpy array of the same shape.
    """
    seed = list(np.asarray(seed, np.int32).ravel())
    if not seed:
        raise ValueError(
            "Empty seed selects the reference's wall-clock mode, which is "
            "not reproducible; provide at least one int32 seed value.")
    x = host_array(inputs, "stochastic_round_reference", np.float32)
    x = x / np.float32(step_size)
    integral = np.floor(x)
    fractional = x - integral
    random = xoshiro.uniform24_stream(seed, x.size).reshape(x.shape)
    return (integral + (random < fractional)).astype(np.int32)
