"""Image quality metrics: PSNR, SSIM, MS-SSIM, and FID / KID over feature
sets (PyTorch counterpart of compression_tpu/util/metrics.py).

The standard formulations: SSIM with an 11x11 Gaussian window of sigma 1.5
applied depthwise without padding, MS-SSIM (Wang et al. 2003) with the
usual power-factor weights and 2x2 average pools between its five scales
(so its input needs at least 176 pixels a side), the Fréchet distance by
symmetric eigendecompositions in float32, and the unbiased cubic-kernel
MMD^2 of KID.  Images are NHWC (or HWC for one image), numpy or torch.
A tensor input stays where it lies; any other input goes to ``device``,
the card unless the caller passes device="cpu" (raising without CUDA).
The metrics return tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from compression_tpu_torch.models import lpips as lpips_lib
from compression_tpu_torch.util.device import resolve_device

__all__ = ["psnr", "ssim", "msssim", "ImageTooSmallError",
           "frechet_distance", "fid_from_features", "kid_from_features",
           "image_perceptual_features"]

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _f32(device, *arrays):
    """float32 tensors of ``arrays``: a tensor stays on its device, any
    other input goes to resolve_device(device)."""
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a), device=resolve_device(device))
        out.append(a.to(torch.float32))
    return out


def psnr(a, b, max_val=255.0, device="cuda"):
    """Peak signal-to-noise ratio over the trailing [H, W, C] dims."""
    a, b = _f32(device, a, b)
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _fspecial_gauss(size, sigma, device):
    coords = torch.arange(size, dtype=torch.float32,
                          device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2(img, kernel):
    """Depthwise convolution without padding of an NHWC batch with a 2-D
    kernel (symmetric, so correlation and convolution agree)."""
    c = img.shape[-1]
    k = kernel[None, None].expand(c, 1, *kernel.shape)
    out = F.conv2d(img.permute(0, 3, 1, 2), k, groups=c)
    return out.permute(0, 2, 3, 1)


def _ssim_components(a, b, max_val, filter_size=11, filter_sigma=1.5,
                     k1=0.01, k2=0.03):
    kernel = _fspecial_gauss(filter_size, filter_sigma, a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _filter2(a, kernel)
    mu_b = _filter2(b, kernel)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _filter2(a * a, kernel) - mu_aa
    sigma_bb = _filter2(b * b, kernel) - mu_bb
    sigma_ab = _filter2(a * b, kernel) - mu_ab
    luminance = (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    contrast_structure = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return luminance, contrast_structure


def _batched(a, b, device):
    a, b = _f32(device, a, b)
    if a.ndim == 3:
        a, b = a[None], b[None]
    return a, b


def ssim(a, b, max_val=255.0, device="cuda", **kwargs):
    """Mean structural similarity over NHWC batches; returns [N]."""
    a, b = _batched(a, b, device)
    luminance, cs = _ssim_components(a, b, max_val, **kwargs)
    return torch.mean(luminance * cs, dim=(1, 2, 3))


def _avg_pool2(x):
    """2x2 average pool, stride 2, flooring odd sizes (NHWC)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ImageTooSmallError(ValueError):
    """An image smaller than MS-SSIM's coarsest scale takes: each scale
    needs the SSIM window (``filter_size`` pixels, 11 by default) a side,
    so five scales need 176."""


def msssim(a, b, max_val=255.0, weights=_MSSSIM_WEIGHTS, device="cuda",
           **kwargs):
    """Multi-scale SSIM (Wang et al. 2003); returns [N].  Raises
    ImageTooSmallError where a scale is smaller than the window."""
    a, b = _batched(a, b, device)
    levels = len(weights)
    window = kwargs.get("filter_size", 11)
    mcs = []
    luminance = None
    for i in range(levels):
        if min(a.shape[1], a.shape[2]) < window:
            raise ImageTooSmallError(
                f"MS-SSIM's scale {i} is {a.shape[1]}x{a.shape[2]}, smaller "
                f"than its {window}-pixel window: {levels} scales need "
                f"{window << (levels - 1)} pixels a side")
        luminance, cs = _ssim_components(a, b, max_val, **kwargs)
        mcs.append(torch.clamp(torch.mean(cs, dim=(1, 2, 3)), min=0.0))
        if i < levels - 1:
            a = _avg_pool2(a)
            b = _avg_pool2(b)
    lum = torch.clamp(torch.mean(luminance, dim=(1, 2, 3)), min=0.0)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=a.device)
    result = torch.prod(
        torch.stack(mcs[:-1], 0) ** weights[:-1, None], dim=0)
    return result * (mcs[-1] * lum) ** weights[-1]


# -- distribution-level perceptual metrics (HiFiC's evaluation columns,
# reference models/hific/data.csv: FID / KID) -------------------------------
def _sqrtm_psd(mat, eps=1e-10):
    """Matrix square root of a symmetric PSD matrix via eigh."""
    w, v = torch.linalg.eigh(mat)
    w = torch.clamp(w, min=eps)
    return (v * torch.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, device="cuda"):
    """Fréchet distance between two Gaussians:
    ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^1/2)."""
    mu1, mu2, cov1, cov2 = _f32(device, mu1, mu2, cov1, cov2)
    s1 = _sqrtm_psd(cov1)
    # Tr sqrt(C1 C2) = Tr sqrt(s1 C2 s1) (a similar PSD matrix).
    inner = s1 @ cov2 @ s1
    w = torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)
    tr_sqrt = torch.sum(torch.sqrt(w))
    return (torch.sum((mu1 - mu2) ** 2) + torch.trace(cov1)
            + torch.trace(cov2) - 2.0 * tr_sqrt)


def fid_from_features(feats_a, feats_b, device="cuda"):
    """Fréchet distance between the Gaussians of two feature sets [N, D]
    (unbiased covariances).  The extractor is the caller's choice
    (``image_perceptual_features`` is the repo's); needs N > D for a
    well-conditioned covariance."""
    a, b = _f32(device, feats_a, feats_b)
    ca = torch.atleast_2d(torch.cov(a.T))
    cb = torch.atleast_2d(torch.cov(b.T))
    return frechet_distance(a.mean(0), ca, b.mean(0), cb, device)


def kid_from_features(feats_a, feats_b, block_size=None, seed=0,
                      device="cuda"):
    """Kernel distance: the unbiased MMD^2 with the cubic kernel
    k(x, y) = (x.y / D + 1)^3 (Binkowski et al. 2018), averaged over
    consecutive blocks of ``block_size`` rows (all rows by default).
    ``seed`` is unused, as in the JAX package."""
    a, b = _f32(device, feats_a, feats_b)
    n = min(a.shape[0], b.shape[0])
    if block_size is None or block_size > n:
        block_size = n
    num_blocks = max(n // block_size, 1)
    d = a.shape[1]

    def poly(x, y):
        return (x @ y.T / d + 1.0) ** 3

    vals = []
    for i in range(num_blocks):
        xa = a[i * block_size:(i + 1) * block_size]
        xb = b[i * block_size:(i + 1) * block_size]
        m = xa.shape[0]
        kxx = poly(xa, xa)
        kyy = poly(xb, xb)
        kxy = poly(xa, xb)
        sum_xx = (torch.sum(kxx) - torch.trace(kxx)) / (m * (m - 1))
        sum_yy = (torch.sum(kyy) - torch.trace(kyy)) / (m * (m - 1))
        sum_xy = torch.mean(kxy)
        vals.append(sum_xx + sum_yy - 2 * sum_xy)
    return torch.mean(torch.stack(vals))


def image_perceptual_features(params, images, input_range=(0.0, 255.0),
                              device="cuda"):
    """Pooled VGG16 embedding of an NHWC image batch for FID / KID: each
    LPIPS tap (``lpips.vgg16_features``, on inputs mapped to [-1, 1]
    without LPIPS's shift and scale) averaged over its positions, the five
    concatenated; [N, 1472].  The pass runs where the images lie; the
    weights are copied there if they lie elsewhere."""
    (x,) = _f32(device, images)
    params = {k: v.to(x.device) for k, v in params.items()}
    lo, hi = input_range
    x = (x - lo) / (hi - lo)
    feats = lpips_lib.vgg16_features(params, x * 2.0 - 1.0)
    pooled = [torch.mean(f, dim=(1, 2)) for f in feats]
    return torch.cat(pooled, dim=-1)
