"""LPIPS perceptual distance (Zhang et al. 2018): PyTorch counterpart of
compression_tpu/models/lpips.py.

``vgg16_features`` runs the VGG16 conv stack (13 3x3 stride-1 convolutions
with zero padding of one, relu after each, 2x2 stride-2 max-pools between
the five stages, which floor odd sizes) and taps the activations after
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3.  ``lpips`` normalizes each
tap to unit channel norm, squares the difference of the two images' taps,
weights the channels by the non-negative linear head and averages over the
positions (the 'lin' variant HiFiC uses).

Images are NHWC (the JAX package's layout); the stack runs NCHW inside.
Weights are a dict of tensors under the JAX package's npz keys, all
float32 and frozen (no gradient is kept for them):

  conv{i}_w, conv{i}_b   for i in 0..12   (HWIO kernels, biases)
  lin{j}_w               for j in 0..4    ([C_j] head weights)

``load_lpips_weights`` reads the same npz as the JAX package;
``random_lpips_weights`` draws the JAX package's recipe (He normal
kernels, zero biases, heads 1 / C) from a torch generator, the stand-in
when no pretrained weights are at hand (nothing is downloaded).  As in the
JAX package, the unit norm adds its epsilon outside the square root.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from compression_tpu_torch.util.device import resolve_device

__all__ = ["vgg16_features", "lpips", "load_lpips_weights",
           "random_lpips_weights", "make_lpips_loss"]

# Channel widths of the 13 VGG16 conv layers and the stage boundaries
# (tap after the last relu of each stage, pool between stages).
_VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                 512)
_STAGE_ENDS = (1, 3, 6, 9, 12)  # conv index whose relu is tapped

# LPIPS input normalization (the torch package's shift / scale for inputs
# in [-1, 1]).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def random_lpips_weights(seed: int = 0, generator=None):
    """He-initialized VGG16 kernels (std sqrt(2 / (9 cin))), zero biases and
    uniform heads 1 / C, on the CPU, drawn from ``generator`` (or one seeded
    with ``seed``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    params = {}
    cin = 3
    for i, cout in enumerate(_VGG_CHANNELS):
        std = float(np.sqrt(2.0 / (9 * cin)))
        params[f"conv{i}_w"] = torch.randn(
            (3, 3, cin, cout), generator=generator) * std
        params[f"conv{i}_b"] = torch.zeros(cout)
        cin = cout
    for j, conv_i in enumerate(_STAGE_ENDS):
        c = _VGG_CHANNELS[conv_i]
        params[f"lin{j}_w"] = torch.full((c,), 1.0 / c)
    return params


def load_lpips_weights(path: str, device="cuda"):
    """Loads LPIPS weights from a local npz (module docstring) onto
    ``device``; the heads are clipped to >= 0.  Raises FileNotFoundError
    when the file is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    device = resolve_device(device)
    params = {}
    with np.load(path) as data:
        for i in range(len(_VGG_CHANNELS)):
            for key in (f"conv{i}_w", f"conv{i}_b"):
                params[key] = torch.tensor(
                    np.asarray(data[key], np.float32), device=device)
        for j in range(len(_STAGE_ENDS)):
            params[f"lin{j}_w"] = torch.tensor(np.asarray(
                data[f"lin{j}_w"], np.float32).reshape(-1),
                device=device).clamp(min=0)
    return params


def _features(params, x):
    """The five taps of an NCHW batch, NCHW."""
    taps = []
    h = x
    for i in range(len(_VGG_CHANNELS)):
        h = F.conv2d(h, params[f"conv{i}_w"].permute(3, 2, 0, 1),
                     params[f"conv{i}_b"], padding=1)
        h = F.relu(h)
        if i in _STAGE_ENDS:
            taps.append(h)
            if i != _STAGE_ENDS[-1]:
                h = F.max_pool2d(h, 2, 2)
    return taps


def vgg16_features(params, x):
    """VGG16 conv features of an NHWC batch; returns the 5 LPIPS taps,
    NHWC."""
    return [t.permute(0, 2, 3, 1)
            for t in _features(params, x.permute(0, 3, 1, 2))]


def _unit_normalize(f, eps=1e-10, dim=1):
    """f over its norm along ``dim`` (the channels; NCHW) plus ``eps``."""
    norm = torch.sqrt(torch.sum(torch.square(f), dim=dim, keepdim=True))
    return f / (norm + eps)


def lpips(params, x, y, input_range=(0.0, 1.0)):
    """LPIPS distance between NHWC image batches; returns [N] distances.

    Images are mapped from ``input_range`` to [-1, 1] and normalized with
    the LPIPS shift / scale before feature extraction, as the torch LPIPS
    package does.  The batches run through the stack one after the other,
    so that backward runs only through the one that needs a gradient.
    """
    lo, hi = input_range
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)

    def taps(im):
        im = ((im - lo) / (hi - lo) * 2.0 - 1.0 - shift) / scale
        return _features(params, im.permute(0, 3, 1, 2))

    total = 0.0
    for j, (a, b) in enumerate(zip(taps(x), taps(y))):
        d = torch.square(_unit_normalize(a) - _unit_normalize(b))
        w = params[f"lin{j}_w"][:, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total


def make_lpips_loss(weights_path: Optional[str] = None, seed: int = 0,
                    device="cuda"):
    """Returns a ``(x, x_hat) -> scalar`` LPIPS loss for HiFiC training,
    its weights frozen on ``device`` (the card unless the caller asks for
    the CPU).

    Loads the weights at ``weights_path`` when that file exists, else uses
    ``random_lpips_weights(seed)`` (as the JAX package does: same graph and
    cost, a weaker metric).
    """
    device = resolve_device(device)
    if weights_path and os.path.exists(weights_path):
        params = load_lpips_weights(weights_path, device=device)
    else:
        params = {k: v.to(device)
                  for k, v in random_lpips_weights(seed=seed).items()}

    def loss_fn(x, x_hat):
        return torch.mean(lpips(params, x, x_hat))

    return loss_fn
