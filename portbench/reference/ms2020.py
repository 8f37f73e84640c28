"""Plain reference of ms2020, the channel-wise autoregressive codec of
Minnen & Singh 2020 ("Channel-wise Autoregressive Entropy Models for
Learned Image Compression", arXiv:2007.08739; TFC's models/ms2020.py), in
float32 on channels-first tensors.  With y split into S slices y_0 ..
y_{S-1} of C / S channels, and s_i the first min(i, K) decoded slices
(K = max_support_slices):

  analysis:        y = g_a(x / 255): three (5x5 conv down 2, GDN), 5x5 conv
                   down 2 to C channels (bmshj2018's transform, imported)
  hyper analysis:  z = h_a(y): 3x3 conv, relu, 5x5 down 2, relu, 5x5 down 2
                   without bias (RDFT kernels, on y as it is: no |y|)
  hyper syntheses: m = h_m(z_hat), c = h_s(z_hat), each 5x5 up 2, relu,
                   5x5 up 2, relu, 3x3, relu (plain kernels)
  slice i:         mu_i    = cc_mean_i([m, s_i])
                   sigma_i = cc_scale_i([c, s_i])       (a scale index)
                   y_hat_i = round(y_i - mu_i) + mu_i   (the decoded
                             integer plus mu_i on the decoder's side)
                   y_hat_i = y_hat_i + 0.5 tanh(lrp_i([m, s_i, y_hat_i]))
                   each predictor 5x5 conv to 224, relu, 5x5 to 128, relu,
                   3x3 to C / S (plain kernels, stride 1)
  synthesis:       x_hat = 255 g_s([y_hat_0, ..., y_hat_{S-1}]): three
                   (5x5 conv up 2, IGDN), 5x5 conv up 2 to 3 channels
                   (bmshj2018's transform, imported)
  y model:         slice element j is coded with the zero-mean NoisyNormal
                   of table row floor(clip(sigma_i[j], 0, L - 1)), whose
                   scale is exp(log 0.11 + row (log 256 - log 0.11) /
                   (L - 1)) for L = 64 scales; z with the deep factorized
                   prior, rounded about zero (TFC's offset_heuristic=False)

Departures from TFC's file, none of which changes a number at the
benchmark's sizes (multiples of 64):

* the hyper syntheses' outputs are cropped to y's extent before the
  concatenation with the slices (TFC concatenates them whole and crops
  mu_i and sigma_i, which works only where the two extents agree);
* only the serving half is here: the rate terms and the training noise
  are left out;
* the caller runs the slice loop (``slice_params``, ``lrp``) and supplies
  each slice's integers: the judge from the container, the control by
  rounding (``quantize``).

``w`` maps the checkpoint's names (``analysis.layer_0.kernel_rdft``,
``cc_mean_3.layer_1.kernel``, ..., ``hyperprior_biases.0``) to tensors.
"""

from __future__ import annotations

import torch

from portbench.reference import bmshj2018
from portbench.reference import ops as ops_lib

MODEL_ID = "ms2020"

analysis = bmshj2018.analysis
synthesis = bmshj2018.synthesis


def hyper_analysis(ops, w, y):
    """y [N, C, h, w] -> z [N, Cz, h / 4, w / 4]."""
    h = y
    for i, (down, act) in enumerate(((1, True), (2, True), (2, False))):
        kernel = ops_lib.rdft_kernel(
            w[f"hyper_analysis.layer_{i}.kernel_rdft"])
        h = ops_lib.signal_conv2d(ops, h, kernel,
                                  w.get(f"hyper_analysis.layer_{i}.bias"),
                                  corr=True, down=down)
        if act:
            h = torch.relu(h)
    return h


def _plain_stack(ops, w, prefix, x, ups, relus, dtype):
    h = x.to(dtype)
    for i, (up, act) in enumerate(zip(ups, relus)):
        h = ops_lib.signal_conv2d(
            ops, h, w[f"{prefix}.layer_{i}.kernel"].to(dtype),
            w[f"{prefix}.layer_{i}.bias"].to(dtype), corr=False, up=up)
        if act:
            h = torch.relu(h)
    return h


def hyper_synthesis(ops, w, z_hat, y_hw, dtype=torch.float32):
    """(m, c): the mean and scale branches of z_hat [N, Cz, h, w], cropped
    to y's extent ``y_hw``, in ``dtype``."""
    out = []
    for branch in ("mean", "scale"):
        h = _plain_stack(ops, w, f"hyper_synthesis_{branch}", z_hat,
                         (2, 2, 1), (True, True, True), dtype)
        out.append(h[:, :, : y_hw[0], : y_hw[1]])
    return tuple(out)


def num_slices(w):
    """How many slices the weights predict."""
    n = 0
    while f"cc_mean_{n}.layer_0.kernel" in w:
        n += 1
    return n


def support(w, i, decoded):
    """s_i: the slices that slice ``i`` is conditioned on (the first
    ``max_support_slices`` of those decoded before it), read from the
    weights' input widths."""
    if not decoded:
        return []
    extra = (w[f"cc_mean_{i}.layer_0.kernel"].shape[2]
             - w["hyper_synthesis_mean.layer_2.kernel"].shape[3])
    return list(decoded[: extra // int(decoded[0].shape[1])])


def predictor(ops, w, name, x):
    """One slice predictor (``cc_mean_i``, ``cc_scale_i``, ``lrp_i``)."""
    return _plain_stack(ops, w, name, x, (1, 1, 1), (True, True, False),
                        x.dtype)


def slice_params(ops, w, i, m, c, decoded):
    """(mu_i, sigma_i, the mean support [m, s_i]) of slice ``i`` from the
    hyper syntheses' outputs and the slices decoded before it."""
    s = support(w, i, decoded)
    mean_support = torch.cat([m] + s, dim=1)
    mu = predictor(ops, w, f"cc_mean_{i}", mean_support)
    sigma = predictor(ops, w, f"cc_scale_{i}", torch.cat([c] + s, dim=1))
    return mu, sigma, mean_support


def lrp(ops, w, i, mean_support, y_hat_slice):
    """The latent residual prediction 0.5 tanh(lrp_i([m, s_i, y_hat_i]))."""
    return 0.5 * torch.tanh(predictor(
        ops, w, f"lrp_{i}", torch.cat([mean_support, y_hat_slice], dim=1)))


def scale_index(sigma, num_scales):
    """The table row of each element: sigma clipped to [0, L - 1], its
    integer part (TFC's cast of the clipped index)."""
    return torch.clamp(sigma, 0.0, num_scales - 1.0).to(torch.int64)


def quantize(y_slice, mu):
    """The slice's integers about its mean: round(y_i - mu_i)."""
    return torch.round(y_slice - mu)


def slice_loop(ops, w, z_hat, y_hw, integers, dtype=torch.float32):
    """y_hat [N, C, h, w] of the slice loop in ``dtype``;
    ``integers(i, mu, sigma)`` gives slice i's integers (a tensor of mu's
    shape)."""
    m, c = hyper_synthesis(ops, w, z_hat, y_hw, dtype)
    decoded = []
    for i in range(num_slices(w)):
        mu, sigma, mean_support = slice_params(ops, w, i, m, c, decoded)
        y_hat = integers(i, mu, sigma).to(dtype) + mu
        decoded.append(y_hat + lrp(ops, w, i, mean_support, y_hat))
    return torch.cat(decoded, dim=1)
