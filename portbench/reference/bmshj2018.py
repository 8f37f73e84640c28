"""Plain reference of bmshj2018, the scale hyperprior of Ballé et al. 2018
(TFC's models/bmshj2018.py), in float32 on channels-first tensors:

  analysis:        x / 255, three (5x5 conv down 2, GDN), 5x5 conv down 2
  synthesis:       three (5x5 conv up 2, IGDN), 5x5 conv up 2, times 255
  hyper analysis:  |y|, 3x3 conv, relu, 5x5 down 2, relu, 5x5 down 2
  hyper synthesis: 5x5 up 2, relu, 5x5 up 2, relu, 3x3 -> scale indexes
  rate:            NoisyDeepFactorized over z, a zero-mean NoisyNormal of
                   the indexed scale over y

``w`` maps the checkpoint's names (``analysis.layer_0.kernel_rdft``, ...,
``hyperprior_biases.0``) to tensors; the analysis, synthesis and hyper
analysis kernels are RDFT parameters, the hyper synthesis kernels plain.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import distributions
from portbench.reference import ops as ops_lib

MODEL_ID = "bmshj2018"


def analysis(ops, w, x):
    """uint8 or float NHWC images -> y [N, C, H / 16, W / 16]."""
    h = (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
    for i in range(4):
        kernel = ops_lib.rdft_kernel(w[f"analysis.layer_{i}.kernel_rdft"])
        h = ops_lib.signal_conv2d(ops, h, kernel,
                                  w[f"analysis.layer_{i}.bias"], corr=True,
                                  down=2)
        if i < 3:
            h = ops_lib.gdn(ops, h, w[f"analysis.gdn_{i}.reparam_beta"],
                            w[f"analysis.gdn_{i}.reparam_gamma"], False)
    return h


def synthesis(ops, w, y):
    """y_hat [N, C, h, w] -> the image [N, 3, 16 h, 16 w] on 0..255."""
    h = y
    for i in range(4):
        kernel = ops_lib.rdft_kernel(w[f"synthesis.layer_{i}.kernel_rdft"])
        h = ops_lib.signal_conv2d(ops, h, kernel,
                                  w[f"synthesis.layer_{i}.bias"], corr=False,
                                  up=2)
        if i < 3:
            h = ops_lib.gdn(ops, h, w[f"synthesis.igdn_{i}.reparam_beta"],
                            w[f"synthesis.igdn_{i}.reparam_gamma"], True)
    return h * 255.0


def hyper_analysis(ops, w, y):
    h = torch.abs(y)
    for i, (down, act) in enumerate(((1, True), (2, True), (2, False))):
        kernel = ops_lib.rdft_kernel(w[f"hyper_analysis.layer_{i}.kernel_rdft"])
        h = ops_lib.signal_conv2d(ops, h, kernel,
                                  w.get(f"hyper_analysis.layer_{i}.bias"),
                                  corr=True, down=down)
        if act:
            h = torch.relu(h)
    return h


def hyper_synthesis(ops, w, z, dtype=torch.float32):
    """z_hat [N, C, h, w] -> scale indexes [N, C, 4 h, 4 w] (before the
    clip to the table), in ``dtype``."""
    h = z.to(dtype)
    for i, (up, act) in enumerate(((2, True), (2, True), (1, False))):
        h = ops_lib.signal_conv2d(
            ops, h, w[f"hyper_synthesis.layer_{i}.kernel"].to(dtype),
            w[f"hyper_synthesis.layer_{i}.bias"].to(dtype), corr=False, up=up)
        if act:
            h = torch.relu(h)
    return h


def y_params(ops, w, z_hat, y_hw, dtype=torch.float64):
    """(scale indexes, location) of y from the decoded hyper-latent, cropped
    to y; bmshj2018 codes y about zero (location None)."""
    idx = hyper_synthesis(ops, w, z_hat, dtype)
    return idx[:, :, : y_hw[0], : y_hw[1]], None


def forward_train(ops, w, x, u_z, u_y, cfg):
    """(loss, bpp, mse) of a training step on a float NHWC batch with the
    noise u_z, u_y (NHWC, the latents' shapes): TFC's bmshj2018 loss,
    bpp + lambda mse, with both latents perturbed by the noise."""
    x = x.to(torch.float32)
    y = analysis(ops, w, x)
    z = hyper_analysis(ops, w, y)
    z_tilde = z + u_z.permute(0, 3, 1, 2)
    prior = distributions.DeepFactorized(distributions.hyperprior_params(w))
    side_log = prior.noisy_log_prob(z_tilde.permute(0, 2, 3, 1))
    idx = hyper_synthesis(ops, w, z_tilde)[:, :, : y.shape[2], : y.shape[3]]
    idx = ops_lib.upper_bound(ops_lib.lower_bound(idx, 0.0),
                              cfg["num_scales"] - 1)
    scale = distributions.scale_table(cfg["scale_min"], cfg["scale_max"],
                                      cfg["num_scales"], idx)
    y_tilde = y + u_y.permute(0, 3, 1, 2)
    y_log = distributions.noisy_normal_log_prob(y_tilde, scale)
    x_hat = synthesis(ops, w, y_tilde)[:, :, : x.shape[1], : x.shape[2]]
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    bits = (y_log.sum() + side_log.sum()) / -math.log(2.0)
    bpp = bits / num_pixels
    mse = torch.mean(torch.square(x.permute(0, 3, 1, 2) - x_hat))
    return bpp + cfg["lmbda"] * mse, bpp, mse
