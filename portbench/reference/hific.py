"""Plain reference of HiFiC's serving half (Mentzer et al. 2020, TFC's
models/hific/{archs,model}.py at ``get_config("hific")``), in float32 on
channels-first tensors:

  encoder:    x / 255 * 2 - 1, 7x7 conv, ChannelNorm, relu, four (3x3
              conv down 2 doubling 60 -> 960 filters, ChannelNorm, relu),
              3x3 conv to the 220-channel bottleneck (flax "SAME" convs)
  generator:  ChannelNorm, 3x3 conv to 960, ChannelNorm (the head); nine
              residual blocks x + CN(conv(relu(CN(conv(x))))); plus the
              head; four (3x3 transposed conv up 2 halving the filters,
              ChannelNorm, relu); 7x7 conv to RGB; (x + 1) / 2 * 255
  hyper:      TFC SignalConv2D: analysis 3x3, relu, 5x5 down 2, relu,
              5x5 down 2 (RDFT kernels, on y as it is); two syntheses
              (scale, mean) 5x5 up 2, relu, 5x5 up 2, relu, 3x3 (plain)
  y model:    location-scale, scale index = the clipped predicted scale's
              position between log 0.11 and log 256 times 63

``w`` maps the checkpoint's names (``encoder.Conv_0.kernel``, ...) to
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import ops as ops_lib

MODEL_ID = "hific"
SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64


def _count(w, pattern):
    """How many of a numbered layer the weights hold."""
    i = 0
    while pattern.format(i) in w:
        i += 1
    return i


def _conv(ops, w, name, h, stride=1):
    return ops_lib.flax_conv(ops, h, w[f"{name}.kernel"], w[f"{name}.bias"],
                             stride)


def _norm(w, name, h):
    return ops_lib.channel_norm(h, w[f"{name}.gamma"], w[f"{name}.beta"])


def analysis(ops, w, x):
    """uint8 or float NHWC images -> y [N, 220, H / 16, W / 16]."""
    down = _count(w, "encoder.ChannelNorm_{}.gamma") - 1
    h = (x.to(torch.float32) / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)
    for i in range(down + 1):
        h = _conv(ops, w, f"encoder.Conv_{i}", h, 1 if i == 0 else 2)
        h = torch.relu(_norm(w, f"encoder.ChannelNorm_{i}", h))
    return _conv(ops, w, f"encoder.Conv_{down + 1}", h)


def synthesis(ops, w, y):
    """y_hat [N, 220, h, w] -> the image [N, 3, 16 h, 16 w] on 0..255."""
    head = _norm(w, "decoder.ChannelNorm_1", _conv(
        ops, w, "decoder.Conv_0", _norm(w, "decoder.ChannelNorm_0", y)))
    h = head
    for b in range(_count(w, "decoder.block_{}.Conv_0.kernel")):
        p = f"decoder.block_{b}"
        r = torch.relu(_norm(w, f"{p}.ChannelNorm_0",
                             _conv(ops, w, f"{p}.Conv_0", h)))
        h = h + _norm(w, f"{p}.ChannelNorm_1", _conv(ops, w, f"{p}.Conv_1", r))
    h = h + head
    for j in range(_count(w, "decoder.ConvTranspose_{}.kernel")):
        name = f"decoder.ConvTranspose_{j}"
        h = ops_lib.flax_conv_transpose(ops, h, w[f"{name}.kernel"],
                                        w[f"{name}.bias"], 2)
        h = torch.relu(_norm(w, f"decoder.ChannelNorm_{j + 2}", h))
    h = _conv(ops, w, "decoder.Conv_1", h)
    return (h + 1.0) / 2.0 * 255.0


def hyper_analysis(ops, w, y):
    h = y
    for i, (down, act) in enumerate(((1, True), (2, True), (2, False))):
        kernel = ops_lib.rdft_kernel(w[f"hyper_analysis.layer_{i}.kernel_rdft"])
        h = ops_lib.signal_conv2d(ops, h, kernel,
                                  w[f"hyper_analysis.layer_{i}.bias"],
                                  corr=True, down=down)
        if act:
            h = torch.relu(h)
    return h


def _hyper_synthesis(ops, w, branch, z, dtype):
    h = z.to(dtype)
    for i, (up, act) in enumerate(((2, True), (2, True), (1, False))):
        name = f"hyper_synthesis_{branch}.layer_{i}"
        h = ops_lib.signal_conv2d(ops, h, w[f"{name}.kernel"].to(dtype),
                                  w[f"{name}.bias"].to(dtype), corr=False,
                                  up=up)
        if act:
            h = torch.relu(h)
    return h


def scale_indexes(raw_scales):
    """Continuous scale-table index of exp(raw): the clipped scale's
    position between log SCALES_MIN and log SCALES_MAX, times 63 (float32
    constants)."""
    log_min = float(np.float32(np.log(SCALES_MIN)))
    span = float(np.float32(np.log(SCALES_MAX) - np.log(SCALES_MIN)))
    s = torch.clamp(torch.exp(raw_scales), SCALES_MIN, SCALES_MAX)
    return (torch.log(s) - log_min) / span * (SCALES_LEVELS - 1)


def y_params(ops, w, z_hat, y_hw, dtype=torch.float64):
    """(scale indexes, means) of y from the decoded hyper-latent, cropped
    to y, in ``dtype``."""
    raw = _hyper_synthesis(ops, w, "scale", z_hat, dtype)
    mean = _hyper_synthesis(ops, w, "mean", z_hat, dtype)
    crop = (slice(None), slice(None), slice(0, y_hw[0]), slice(0, y_hw[1]))
    return scale_indexes(raw[crop]), mean[crop]
