"""Parameter reparameterizations (PyTorch counterpart of
compression_tpu/layers/parameters.py).

* RDFT: a convolution kernel stored as the real and imaginary parts of its
  real-input DFT with 1/sqrt(N) normalization, mapped back by a dense basis
  matmul (the bases are computed once per spatial shape with numpy in
  float64, as the JAX package does).
* GDN: nonnegative values stored as their square roots plus a pedestal,
  read back through ``lower_bound``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from compression_tpu_torch.ops import math_ops

__all__ = ["rdft_init", "rdft_to_kernel", "gdn_param_init", "gdn_param_value"]


@functools.lru_cache(maxsize=None)
def _rdft_bases(spatial_shape):
    """(fwd_r [N, K], fwd_i [N, K], inv_r [K, N], inv_i [K, N]) float32
    numpy; K = prod(rfft shape), N = prod(spatial_shape)."""
    n = int(np.prod(spatial_shape))
    rfft_shape = tuple(spatial_shape[:-1]) + (spatial_shape[-1] // 2 + 1,)
    k = int(np.prod(rfft_shape))
    axes = tuple(range(1, len(spatial_shape) + 1))
    eye = np.eye(n, dtype=np.float64).reshape((n,) + tuple(spatial_shape))
    fwd = np.fft.rfftn(eye, axes=axes).reshape(n, k)
    eye_k = np.eye(k, dtype=np.complex128).reshape((k,) + rfft_shape)
    inv_r = np.fft.irfftn(eye_k.real, s=spatial_shape, axes=axes)
    inv_i = np.fft.irfftn(eye_k.real * 1j, s=spatial_shape, axes=axes)
    return tuple(np.ascontiguousarray(a.reshape(a.shape[0], -1), np.float32)
                 for a in (fwd.real, fwd.imag, inv_r, inv_i))


def _spatial_last(kernel_rank):
    """Permutation moving (spatial..., in, out) -> (in, out, spatial...)."""
    spatial = kernel_rank - 2
    return (spatial, spatial + 1) + tuple(range(spatial))


def _spatial_first(kernel_rank):
    """Permutation moving (in, out, spatial...) -> (spatial..., in, out)."""
    return tuple(range(2, kernel_rank)) + (0, 1)


def rdft_init(kernel):
    """(real, imag) RDFT variables [in, out, *rfft] of a kernel
    [spatial..., in, out] of rank 3 to 5 (the JAX package's layout)."""
    rank = kernel.dim()
    if rank not in (3, 4, 5):
        raise ValueError(f"Kernel must have rank 3..5, got {rank}.")
    spatial_shape = tuple(int(s) for s in kernel.shape[:-2])
    rfft_shape = spatial_shape[:-1] + (spatial_shape[-1] // 2 + 1,)
    moved = kernel.permute(_spatial_last(rank))
    flat = moved.reshape(moved.shape[:2] + (-1,))
    fwd_r, fwd_i, _, _ = _rdft_bases(spatial_shape)
    norm = float(np.prod(spatial_shape)) ** 0.5
    real = flat @ torch.as_tensor(fwd_r, device=kernel.device) / norm
    imag = flat @ torch.as_tensor(fwd_i, device=kernel.device) / norm
    return (real.reshape(moved.shape[:2] + rfft_shape),
            imag.reshape(moved.shape[:2] + rfft_shape))


def rdft_to_kernel(real, imag, spatial_shape):
    """Inverse RDFT back to a [spatial..., in, out] kernel."""
    spatial_shape = tuple(int(s) for s in spatial_shape)
    _, _, inv_r, inv_i = _rdft_bases(spatial_shape)
    norm = float(np.prod(spatial_shape)) ** 0.5
    flat_r = real.reshape(real.shape[:2] + (-1,))
    flat_i = imag.reshape(imag.shape[:2] + (-1,))
    kernel = (flat_r @ torch.as_tensor(inv_r, device=real.device)
              + flat_i @ torch.as_tensor(inv_i, device=real.device)) * norm
    kernel = kernel.reshape(kernel.shape[:2] + spatial_shape)
    return kernel.permute(_spatial_first(len(spatial_shape) + 2))


def gdn_param_init(initial_value, offset=2**-18):
    """Maps an initial nonnegative value to its stored square-root form."""
    pedestal = torch.tensor(offset**2, dtype=initial_value.dtype)
    return torch.sqrt(torch.maximum(initial_value + pedestal, pedestal))


def gdn_param_value(variable, minimum=0.0, offset=2**-18):
    """Reads back the nonnegative value: max(var, bound)^2 - offset^2."""
    pedestal = torch.tensor(offset**2, dtype=variable.dtype,
                            device=variable.device)
    bound = (minimum + offset**2) ** 0.5
    return torch.square(math_ops.lower_bound(variable, bound)) - pedestal
