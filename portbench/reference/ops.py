"""Plain operations of the reference transforms, written from the published
equations and nothing of the program:

* TFC's SignalConv2D (upsample by zero insertion, pad, correlate or
  convolve, downsample; "same_zeros") with its RDFT kernel parameter;
* TFC's GDN / IGDN with the square-root reparameterization of beta and
  gamma, and the bound ops' "identity_if_towards" gradient;
* flax's Conv and ConvTranspose with padding "SAME" (XLA's split of the
  padding), and HiFiC's ChannelNorm.

Tensors are channels-first [N, C, H, W]; kernels are stored HWIO, as the
checkpoints of both models store them.

``Ops`` carries the precision: float32 (TF32 off), or the control's TF32.
On a GPU the control runs cuDNN and cuBLAS with TF32 on; on the CPU, which
has no TF32, it rounds each product's operands to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def round_to_tf32(x):
    """x with its float32 mantissa rounded to TF32's 10 bits (nearest,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Ops:
    """Convolutions and channel mixing in the configuration's precision
    (``tf32=False``) or in the control's (``tf32=True``)."""

    def __init__(self, tf32=False):
        self.tf32 = bool(tf32)

    @contextlib.contextmanager
    def precision(self):
        """Sets cuDNN's and cuBLAS's TF32 switches for the duration."""
        old = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield self
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = old

    def _operands(self, *xs):
        if (self.tf32 and xs[0].device.type == "cpu"
                and xs[0].dtype == torch.float32):
            return tuple(round_to_tf32(x) for x in xs)
        return xs

    def conv2d(self, x, weight_oihw, bias=None, stride=1):
        x, weight_oihw = self._operands(x, weight_oihw)
        return F.conv2d(x, weight_oihw, bias, stride=stride)

    def mix(self, x, matrix):
        """out[:, i] = sum_j matrix[j, i] x[:, j] (a 1x1 convolution)."""
        x, matrix = self._operands(x, matrix)
        return torch.einsum("njhw,ji->nihw", x, matrix)


# -- bounds with TFC's gradients ------------------------------------------
class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x up toward the bound ("identity_if_towards")."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * ((x >= ctx.bound) | (grad < 0)).to(grad.dtype), None


class _UpperBound(torch.autograd.Function):
    """min(x, bound), the mirror of ``_LowerBound``."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * ((x <= ctx.bound) | (grad > 0)).to(grad.dtype), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, float(bound))


def upper_bound(x, bound):
    return _UpperBound.apply(x, float(bound))


# -- TFC's RDFT kernel parameter ------------------------------------------
def _irdft_basis(k):
    """[K * (K // 2 + 1), K * K] float64 matrices (for the real and the
    imaginary parts) of the inverse real 2-D DFT of an odd K x K kernel,
    scaled by sqrt(K * K): the kernel is the real part of the inverse DFT
    over the first axis, then the inverse real DFT over the second, whose
    zero-frequency bin contributes its real part only."""
    if k % 2 == 0:
        raise ValueError("the reference's RDFT takes odd kernel sizes")
    r = k // 2 + 1
    n = np.arange(k)
    k0, k1 = np.meshgrid(np.arange(k), np.arange(r), indexing="ij")
    n0, n1 = np.meshgrid(n, n, indexing="ij")
    phase = 2 * np.pi * (k0.reshape(-1, 1) * n0.reshape(1, -1)
                         + k1.reshape(-1, 1) * n1.reshape(1, -1)) / k
    weight = np.where(k1.reshape(-1, 1) == 0, 1.0, 2.0)
    scale = math.sqrt(k * k) / (k * k)
    real = weight * np.cos(phase) * scale
    imag = -weight * np.sin(phase) * scale
    # The zero-frequency bin of the second axis keeps its real part: the
    # imaginary part of the first axis's inverse DFT is dropped there.
    return real, imag


def rdft_kernel(rdft):
    """[2, in, out, K, K // 2 + 1] RDFT parameter -> HWIO kernel."""
    _, cin, cout, k, r = rdft.shape
    basis_r, basis_i = _irdft_basis(int(k))
    dev = rdft.device
    flat_r = rdft[0].reshape(cin, cout, k * r)
    flat_i = rdft[1].reshape(cin, cout, k * r)
    kernel = (flat_r @ torch.as_tensor(basis_r, dtype=torch.float32,
                                       device=dev)
              + flat_i @ torch.as_tensor(basis_i, dtype=torch.float32,
                                         device=dev))
    return kernel.reshape(cin, cout, k, k).permute(2, 3, 0, 1)


def signal_conv2d(ops, x, kernel, bias=None, *, corr, down=1, up=1):
    """TFC's SignalConv2D with "same_zeros" padding on a square kernel
    (HWIO): zero insertion by ``up``, padding so that output sample i
    lines up with input sample i, correlation (``corr``) or convolution,
    then every ``down``-th sample."""
    k = int(kernel.shape[0])
    if not corr:
        kernel = torch.flip(kernel, dims=(0, 1))
    if up > 1:
        n, c, h, w = x.shape
        grid = x.new_zeros((n, c, (h - 1) * up + 1, (w - 1) * up + 1))
        grid[:, :, ::up, ::up] = x
        x = grid
    before = k // 2 if corr else (k - 1) // 2
    after = k - 1 - before + (up - 1)
    x = F.pad(x, (before, after, before, after))
    return ops.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=down)


# -- GDN ------------------------------------------------------------------
_PEDESTAL = (2.0**-18) ** 2


def gdn_value(reparam, minimum):
    """The nonnegative value a reparameterized GDN variable stands for:
    max(v, sqrt(minimum + pedestal))^2 - pedestal."""
    bound = (minimum + _PEDESTAL) ** 0.5
    return torch.square(lower_bound(reparam, bound)) - _PEDESTAL


def gdn(ops, x, reparam_beta, reparam_gamma, inverse):
    """y_i = x_i / (beta_i + sum_j gamma_ji |x_j|) (GDN), or times it
    (IGDN)."""
    beta = gdn_value(reparam_beta, 1e-6)
    gamma = gdn_value(reparam_gamma, 0.0)
    norm = ops.mix(torch.abs(x), gamma) + beta[None, :, None, None]
    return x * norm if inverse else x / norm


# -- flax convolutions and ChannelNorm (HiFiC) ------------------------------
def _same_pads(n, k, s):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def flax_conv(ops, x, kernel, bias, stride=1):
    """flax nn.Conv, padding "SAME": XLA pads the total
    max((ceil(n / s) - 1) s + k - n, 0), its floor half before."""
    k = int(kernel.shape[0])
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return ops.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=stride)


def flax_conv_transpose(ops, x, kernel, bias, stride):
    """flax nn.ConvTranspose, padding "SAME": the input dilated by the
    stride, padded by lax's conv_transpose rule (k + s - 2 in all,
    ceil of half before when s <= k - 1), correlated with the kernel as
    stored."""
    k, s = int(kernel.shape[0]), int(stride)
    total = k + s - 2
    before = k - 1 if s > k - 1 else -(-total // 2)
    after = total - before
    n, c, h, w = x.shape
    grid = x.new_zeros((n, c, (h - 1) * s + 1, (w - 1) * s + 1))
    grid[:, :, ::s, ::s] = x
    grid = F.pad(grid, (before, after, before, after))
    return ops.conv2d(grid, kernel.permute(3, 2, 0, 1), bias)


def channel_norm(x, gamma, beta, epsilon=1e-3):
    """(x - mean) / sqrt(unbiased variance + eps) over the channels, then
    gamma and beta."""
    mean = x.mean(dim=1, keepdim=True)
    var = torch.var(x, dim=1, keepdim=True, unbiased=True)
    return ((x - mean) / torch.sqrt(var + epsilon) * gamma[:, None, None]
            + beta[:, None, None])
