"""Generalized divisive normalization (PyTorch counterpart of
compression_tpu/layers/gdn.py; Ballé et al., "Density modeling of images
using a generalized normalization transformation"):

    y[i] = x[i] / (beta[i] + sum_j gamma[j, i] * |x[j]|^alpha)^epsilon

and IGDN with the division replaced by a multiplication.  Channels-first
input [N, C, spatial...] with 0 to 3 spatial axes; the channel mixing is a
1x1 convolution (a matmul without spatial axes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.layers import parameters

__all__ = ["GDN"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class GDN(nn.Module):
    """GDN (inverse=False) or IGDN (inverse=True).

    Args:
      num_channels: C, the size of axis 1.
      inverse: False -> GDN (divide), True -> IGDN (multiply).
      rectify: apply relu to the inputs first.
      alpha: fixed exponent on the inputs (1 and 2 take fast paths); None
        trains it (parameter ``reparam_alpha``, minimum 1).
      epsilon: fixed exponent on the norm pool (1 and 0.5 take fast
        paths); None trains it (parameter ``reparam_epsilon``, minimum
        1e-6).
      beta_minimum / gamma_init: the reference's defaults (beta starts at
        1, gamma at gamma_init * I).
    """

    def __init__(self, num_channels, inverse=False, rectify=False, alpha=1.0,
                 epsilon=1.0, beta_minimum=1e-6, gamma_init=0.1):
        super().__init__()
        self.inverse = bool(inverse)
        self.rectify = bool(rectify)
        self.alpha = None if alpha is None else float(alpha)
        self.epsilon = None if epsilon is None else float(epsilon)
        self.beta_minimum = float(beta_minimum)
        self.reparam_beta = nn.Parameter(
            parameters.gdn_param_init(torch.ones(num_channels)))
        self.reparam_gamma = nn.Parameter(parameters.gdn_param_init(
            gamma_init * torch.eye(num_channels)))
        if alpha is None:
            self.reparam_alpha = nn.Parameter(
                parameters.gdn_param_init(torch.ones(())))
        if epsilon is None:
            self.reparam_epsilon = nn.Parameter(
                parameters.gdn_param_init(torch.ones(())))

    def forward(self, x):
        rank = x.dim() - 2
        if rank not in (0, 1, 2, 3):
            raise ValueError(
                f"Input must be [N, C] with 0 to 3 spatial axes, got "
                f"{tuple(x.shape)}.")
        beta = parameters.gdn_param_value(self.reparam_beta,
                                          minimum=self.beta_minimum)
        gamma = parameters.gdn_param_value(self.reparam_gamma, minimum=0.0)
        if self.rectify:
            x = F.relu(x)

        if self.alpha == 1.0 and self.rectify:
            norm_pool = x
        elif self.alpha == 1.0:
            norm_pool = torch.abs(x)
        elif self.alpha == 2.0:
            norm_pool = torch.square(x)
        else:
            alpha = (parameters.gdn_param_value(self.reparam_alpha,
                                                minimum=1.0)
                     if self.alpha is None else self.alpha)
            norm_pool = torch.abs(x) ** alpha

        # gamma[j, i] pools input channel j into output channel i.
        if rank == 0:
            norm_pool = torch.addmm(beta, norm_pool, gamma)
        else:
            weight = gamma.t()[(slice(None), slice(None)) + (None,) * rank]
            norm_pool = _CONV[rank](norm_pool, weight, beta)

        if self.epsilon == 0.5:
            norm_pool = torch.sqrt(norm_pool)
        elif self.epsilon != 1.0:
            epsilon = (parameters.gdn_param_value(self.reparam_epsilon,
                                                  minimum=1e-6)
                       if self.epsilon is None else self.epsilon)
            norm_pool = norm_pool ** epsilon
        return x * norm_pool if self.inverse else x / norm_pool
