"""DSP-correct signal convolutions (PyTorch counterpart of
compression_tpu/layers/signal_conv.py: ``signal_conv`` and SignalConv1D /
2D / 3D).

Semantics follow the reference: upsample (zero insertion) -> pad -> correlate
(or convolve, with the kernel flipped) -> downsample -> bias -> activation.
The kernel center sits at K//2 for correlation and (K-1)//2 after the flip of
a convolution, and padding and alignment do not depend on the input's size.

Padding modes:
  * 'valid': no assumptions outside the input support (the default, as in
    the JAX package);
  * 'same_zeros': zero extension; output sample i aligns with (upsampled)
    input sample i;
  * 'same_reflect': reflection around the first and last sample of the
    upsampled grid, then zeros for whatever the reflection cannot cover,
    as the JAX package pads.

Both strides may exceed 1 at once (rational resampling), and
``channel_separable`` filters each input channel on its own (output channel
``c_in * filters + f``).  One case keeps a lowering of its own, the image
models' upsampling layers: a 2-D 'same_zeros' convolution of odd support
without downsampling is ``F.conv_transpose2d``.  Everything else upsamples
on the grid, pads, and runs ``F.conv{1,2,3}d`` with ``stride=strides_down``.

Tensors are channels-first, PyTorch's layout: inputs [N, C, spatial...].
Kernels keep the JAX layout [spatial..., in, out] ([spatial..., 1,
in * filters] when channel-separable).  A module stores its kernel as its
RDFT (``kernel_parameter="rdft"``: parameter ``kernel_rdft``, real and
imaginary parts stacked, [2, in, out, *rfft]) or plainly
(``kernel_parameter="variable"``: parameter ``kernel``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.layers import parameters

__all__ = ["SignalConv1D", "SignalConv2D", "SignalConv3D", "signal_conv"]

# std of a standard normal truncated to (-2, 2): the reference's
# VarianceScaling(fan_in, truncated_normal) init divides by it.
_TRUNC_STD = 0.87962566103423978

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_PADDINGS = ("valid", "same_zeros", "same_reflect")


def _tuplize(value, rank):
    if isinstance(value, (int, np.integer)):
        return (int(value),) * rank
    value = tuple(int(v) for v in value)
    if len(value) != rank:
        raise ValueError(f"Expected length-{rank} tuple, got {value}.")
    return value


def _flat_pads(pads):
    """Per-dimension (before, after) pairs in F.pad's order (last first)."""
    return [p for pair in reversed(pads) for p in pair]


def _upsample(x, strides_up):
    """Zero insertion: length (n - 1) * s + 1 along each spatial axis."""
    shape = list(x.shape[:2]) + [
        (n - 1) * s + 1 for n, s in zip(x.shape[2:], strides_up)]
    up = x.new_zeros(shape)
    up[(slice(None), slice(None))
       + tuple(slice(None, None, s) for s in strides_up)] = x
    return up


def _reflect(x, dim, before, after):
    """numpy's 'reflect' padding along ``dim``, for pads of any size (the
    reflection repeats with period 2 (n - 1))."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        idx = torch.remainder(idx, 2 * (n - 1))
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return x.index_select(dim, idx)


def signal_conv(inputs, kernel, *, corr=False, strides_down=1, strides_up=1,
                padding="valid", extra_pad_end=True, channel_separable=False,
                bias=None):
    """Functional signal convolution on a channels-first batch.

    Args:
      inputs: [batch, channels_in, spatial...] (1 to 3 spatial axes).
      kernel: [spatial..., channels_in, filters], or for channel_separable
        [spatial..., 1, channels_in * filters] grouped by input channel.
      corr: cross-correlation if True, convolution (flipped kernel) if
        False.
      strides_down / strides_up: int or per-axis tuples.
      padding: 'valid' | 'same_zeros' | 'same_reflect'.
      extra_pad_end: pad the upsampled grid to a multiple of strides_up.
      channel_separable: depthwise (per-input-channel) filtering.
      bias: optional [out_channels] added to the output.

    Returns:
      [batch, filters (* channels_in if separable), spatial_out...].
    """
    rank = inputs.dim() - 2
    if rank not in _CONV:
        raise ValueError(f"Inputs must have 1 to 3 spatial axes, got {rank}.")
    strides_down = _tuplize(strides_down, rank)
    strides_up = _tuplize(strides_up, rank)
    support = tuple(int(s) for s in kernel.shape[:rank])
    padding = padding.lower()
    if padding not in _PADDINGS:
        raise ValueError(f"Unsupported padding mode: {padding}")
    ones = (1,) * rank

    if (rank == 2 and padding == "same_zeros" and not channel_separable
            and not corr and strides_down == ones
            and (extra_pad_end or strides_up == ones)
            and all(k % 2 for k in support)):
        # Convolution on the upsampled grid: pad (K-1)//2 before and
        # K-1-(K-1)//2 + strides_up-1 after (the same for odd K);
        # conv_transpose2d pads K-1-p on both sides and output_padding
        # more at the end.
        return F.conv_transpose2d(
            inputs, kernel.permute(2, 3, 0, 1), bias, stride=strides_up,
            padding=tuple(k - 1 - (k - 1) // 2 for k in support),
            output_padding=tuple(s - 1 for s in strides_up))

    if not corr:
        kernel = torch.flip(kernel, dims=tuple(range(rank)))
    x = _upsample(inputs, strides_up) if strides_up != ones else inputs
    pads = []
    for k, s in zip(support, strides_up):
        extra = s - 1 if extra_pad_end else 0
        if padding == "valid":
            pads.append((0, extra))
        else:
            before = k // 2 if corr else (k - 1) // 2
            pads.append((before, k - 1 - before + extra))
    if padding == "same_reflect":
        # Reflect as far as the grid reaches at the end (n - 1 samples),
        # then zeros.
        tail = []
        for d, (before, after) in enumerate(pads):
            reach = min(after, x.shape[d + 2] - 1)
            x = _reflect(x, d + 2, before, reach)
            tail.append((0, after - reach))
        pads = tail
    if any(p != (0, 0) for p in pads):
        x = F.pad(x, _flat_pads(pads))
    weight = kernel.permute((rank + 1, rank) + tuple(range(rank)))
    groups = inputs.shape[1] if channel_separable else 1
    return _CONV[rank](x, weight, bias, stride=strides_down, groups=groups)


class _SignalConv(nn.Module):
    """Signal convolution layer of ``rank`` spatial axes; see
    ``signal_conv`` for the semantics."""

    rank = None

    def __init__(self, in_channels, filters, kernel_support, corr=False,
                 strides_down=1, strides_up=1, padding="valid",
                 extra_pad_end=True, channel_separable=False, use_bias=False,
                 activation=None, kernel_parameter="rdft", generator=None):
        super().__init__()
        if kernel_parameter not in ("rdft", "variable"):
            raise ValueError(
                f"Unknown kernel_parameter '{kernel_parameter}'.")
        if padding.lower() not in _PADDINGS:
            raise ValueError(f"Unsupported padding mode: {padding}")
        rank = self.rank
        self.support = _tuplize(kernel_support, rank)
        self.filters = int(filters)
        self.corr = bool(corr)
        self.strides_down = _tuplize(strides_down, rank)
        self.strides_up = _tuplize(strides_up, rank)
        self.padding = padding.lower()
        self.extra_pad_end = bool(extra_pad_end)
        self.channel_separable = bool(channel_separable)
        self.activation = activation
        if channel_separable:
            shape = self.support + (1, in_channels * filters)
        else:
            shape = self.support + (in_channels, filters)
        fan_in = int(np.prod(self.support)) * in_channels
        kernel = torch.empty(shape)
        nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
        kernel *= (1.0 / max(fan_in, 1)) ** 0.5 / _TRUNC_STD
        self.kernel_parameter = kernel_parameter
        if kernel_parameter == "rdft":
            real, imag = parameters.rdft_init(kernel)
            self.kernel_rdft = nn.Parameter(torch.stack([real, imag]))
        else:
            self.kernel = nn.Parameter(kernel)
        out_channels = shape[-1]
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def kernel_value(self):
        """The kernel in the JAX layout [spatial..., in, out]."""
        if self.kernel_parameter == "variable":
            return self.kernel
        return parameters.rdft_to_kernel(
            self.kernel_rdft[0], self.kernel_rdft[1], self.support)

    def forward(self, x):
        out = signal_conv(
            x, self.kernel_value(), corr=self.corr,
            strides_down=self.strides_down, strides_up=self.strides_up,
            padding=self.padding, extra_pad_end=self.extra_pad_end,
            channel_separable=self.channel_separable, bias=self.bias)
        return out if self.activation is None else self.activation(out)


class SignalConv1D(_SignalConv):
    """1-D signal convolution (inputs [N, C, W])."""

    rank = 1


class SignalConv2D(_SignalConv):
    """2-D signal convolution (inputs [N, C, H, W])."""

    rank = 2


class SignalConv3D(_SignalConv):
    """3-D signal convolution (inputs [N, C, D, H, W])."""

    rank = 3
