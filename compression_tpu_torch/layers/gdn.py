"""Generalized divisive normalization (PyTorch counterpart of
compression_tpu/layers/gdn.py for alpha = epsilon = 1, the bls2017 case):

    y[i] = x[i] / (beta[i] + sum_j gamma[j, i] * |x[j]|)

and IGDN with the division replaced by a multiplication.  NCHW input; the
channel mixing is a 1x1 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.layers import parameters

__all__ = ["GDN"]


class GDN(nn.Module):
    """GDN (inverse=False) or IGDN (inverse=True)."""

    def __init__(self, num_channels, inverse=False):
        super().__init__()
        self.inverse = bool(inverse)
        # The reference's initial values: beta = 1, gamma = 0.1 * I.
        self.reparam_beta = nn.Parameter(
            parameters.gdn_param_init(torch.ones(num_channels)))
        self.reparam_gamma = nn.Parameter(parameters.gdn_param_init(
            0.1 * torch.eye(num_channels)))

    def forward(self, x):
        beta = parameters.gdn_param_value(self.reparam_beta, minimum=1e-6)
        gamma = parameters.gdn_param_value(self.reparam_gamma, minimum=0.0)
        # gamma[j, i] pools input channel j into output channel i.
        norm_pool = F.conv2d(torch.abs(x), gamma.t()[:, :, None, None], beta)
        return x * norm_pool if self.inverse else x / norm_pool
