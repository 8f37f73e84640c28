"""Signal convolution (PyTorch counterpart of
compression_tpu/layers/signal_conv.py:SignalConv2D).

The port covers what bls2017 and bmshj2018 use: 'same_zeros' padding with
either a correlation (corr=True, strides_down >= 1) or a convolution
(corr=False, strides_up >= 1), with or without a bias.  Semantics follow the reference: the
kernel center sits at K//2 for correlation and (K-1)//2 after the flip of a
convolution, and an upsampled output is exactly ``strides_up`` times the
input.  The kernel is stored as its RDFT (``kernel_parameter="rdft"``:
parameter ``kernel_rdft``, real and imaginary parts stacked, layout [2, in,
out, kh, kw//2+1] as in the JAX package) or plainly
(``kernel_parameter="variable"``: parameter ``kernel``, HWIO).  Layers take NCHW tensors, PyTorch's layout; the model
transforms convert from and to the JAX package's NHWC at their edges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.layers import parameters

__all__ = ["SignalConv2D"]

# std of a standard normal truncated to (-2, 2): the reference's
# VarianceScaling(fan_in, truncated_normal) init divides by it.
_TRUNC_STD = 0.87962566103423978


class SignalConv2D(nn.Module):
    """2-D signal convolution with an RDFT-parameterized or plain kernel
    and 'same_zeros' padding."""

    def __init__(self, in_channels, filters, kernel_support, corr=False,
                 strides_down=1, strides_up=1, use_bias=False,
                 kernel_parameter="rdft", generator=None):
        super().__init__()
        if kernel_parameter not in ("rdft", "variable"):
            raise ValueError(
                f"Unknown kernel_parameter '{kernel_parameter}'.")
        if (corr and strides_up != 1) or (not corr and strides_down != 1):
            raise NotImplementedError(
                "only corr with strides_down or conv with strides_up")
        self.support = int(kernel_support)
        self.filters = int(filters)
        self.corr = bool(corr)
        self.strides_down = int(strides_down)
        self.strides_up = int(strides_up)
        k = self.support
        fan_in = k * k * in_channels
        kernel = torch.empty((k, k, in_channels, filters))
        nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
        kernel *= (1.0 / fan_in) ** 0.5 / _TRUNC_STD
        self.kernel_parameter = kernel_parameter
        if kernel_parameter == "rdft":
            real, imag = parameters.rdft_init(kernel)
            self.kernel_rdft = nn.Parameter(torch.stack([real, imag]))
        else:
            self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    def hwio_kernel(self):
        """The [kh, kw, in, out] kernel (HWIO, as the JAX package)."""
        if self.kernel_parameter == "variable":
            return self.kernel
        return parameters.rdft_to_kernel(
            self.kernel_rdft[0], self.kernel_rdft[1],
            (self.support, self.support))

    def forward(self, x):
        k = self.support
        kernel = self.hwio_kernel()
        if self.corr:
            before = k // 2
            after = k - 1 - before
            x = F.pad(x, (before, after, before, after))
            return F.conv2d(x, kernel.permute(3, 2, 0, 1), self.bias,
                            stride=self.strides_down)
        # Convolution on the upsampled grid: pad (K-1)//2 before and
        # K-1-(K-1)//2 + strides_up-1 after; conv_transpose2d pads K-1-p on
        # both sides and output_padding more at the end.
        u = self.strides_up
        p = k - 1 - (k - 1) // 2
        return F.conv_transpose2d(x, kernel.permute(2, 3, 0, 1), self.bias,
                                  stride=u, padding=p, output_padding=u - 1)
