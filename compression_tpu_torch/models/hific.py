"""HiFiC: High-Fidelity Generative Image Compression (Mentzer et al. 2020):
its serving path and its GAN training (PyTorch counterpart of
compression_tpu/models/hific.py).

An encoder of plain convolutions with ChannelNorm (a 7x7 head, ``num_down``
3x3 stride-2 convolutions, a 3x3 bottleneck), a generator (ChannelNorm, a
3x3 head, ``num_residual_blocks`` residual blocks with a skip, ``num_down``
3x3 stride-2 transposed convolutions, a 7x7 tail) and a mean / scale
hyperprior over the bottleneck: a hyper analysis and two hyper syntheses
of SignalConv2D, a NoisyDeepFactorized prior over z and a location-scale
indexed model over y whose scale indexes are continuous (the clipped
predicted scale's position on the log scale table).

``HiFiCCodec`` is ``bmshj2018.BMSHJ2018Codec`` with the y model's location
(the mean branch): the same two containers (classic: y and z in one
reference-format stream each, 5 tensors; native: row streams plus escape
sidecars, 9 tensors), the same entry points (``compress``,
``compress_native(_many)``, ``decompress(_native_many)``,
``reconstruct``), one transform path for all of them.  z's quantization
offset comes from the prior (the entropy model's offset heuristic), as in
the JAX package's codec.  Weights come from a seeded init or from the JAX
package (``params_from_jax``).  Images are uint8 [H, W, 3] (numpy or
torch), latents [1, H, W, C], the JAX package's NHWC layout; images enter
the encoder as x / 255 * 2 - 1 and leave the generator as (x + 1) / 2 *
255.

Training is the reference's two-optimizer GAN: ``HiFiCModel.forward(
training=True)`` gives the reconstruction, the rounded latent and the
noisy and quantized rates; ``rd_loss`` weighs rate against distortion on
the target-rate schedule; ``make_train_steps`` builds the generator step
(MSE, rate, ``CP`` x LPIPS (``models/lpips.py``) and ``CP`` x the
non-saturating adversarial loss) and the discriminator step over a
``Discriminator``, a latent-conditioned patch discriminator whose
convolutions carry flax's ``SpectralNorm`` (power-iteration state ``u``
and ``sigma`` in buffers, as flax keeps them in ``batch_stats``); ``train``
runs both with Adam and ``main`` is HiFiC's command line (train /
compress / decompress).

The plain convolutions carry flax's semantics: kernels stored HWIO; "SAME"
padding split as XLA splits it (the total max((ceil(n / s) - 1) s + k - n,
0), its floor half before), which is (0, 1) for a 3x3 stride-2 conv on an
even axis; a transposed convolution is the correlation of the dilated
input with the kernel as stored, i.e. torch's transposed convolution with
the kernel flipped, its first s n outputs kept.

"High-Fidelity Generative Image Compression"
https://arxiv.org/abs/2006.09965
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    LocationScaleIndexedEntropyModel)
from compression_tpu_torch.layers.signal_conv import SignalConv2D
from compression_tpu_torch.models import lpips as lpips_lib
from compression_tpu_torch.models.bmshj2018 import (BMSHJ2018Codec,
                                                    make_scale_fn)
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util import profiling
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "HiFiCConfig",
    "get_config",
    "valid_configs",
    "ChannelNorm",
    "Conv",
    "ConvTranspose",
    "ResidualBlock",
    "Encoder",
    "Decoder",
    "HyperAnalysis",
    "HyperSynthesis",
    "HiFiCModel",
    "HiFiCCodec",
    "SpectralNorm",
    "Discriminator",
    "params_from_jax",
    "disc_params_from_jax",
    "rd_loss",
    "make_train_steps",
    "train",
    "model_from_config",
    "main",
]

SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64

#: Convolutions run as one matrix product (``Conv.gemm``: the generator's
#: trunk, 1 + 2 x ``num_residual_blocks`` an image synthesized) since the
#: count was last reset.
GEMM_CONVS = 0

#: Layers of the generator's upsampling stack run as one matrix product and
#: an overlap-add (``overlap_add``: its ``num_down`` transposed convolutions
#: and its 7x7 tail, ``num_down`` + 1 an image synthesized) since the count
#: was last reset.
GEMM_UPSAMPLES = 0


class HiFiCConfig(NamedTuple):
    """Mirrors the reference 'hific' config (configs.py:20-48)."""

    num_down: int = 4
    num_filters_base: int = 60
    num_filters_bottleneck: int = 220
    num_residual_blocks: int = 9
    hyper_filters: int = 320
    # Loss schedule.
    C: float = 0.1 * 2.0**-5
    CD: float = 0.75
    CP: float = 0.1 * 1.5
    target: float = 0.14
    target_factor_initial: float = 0.20 / 0.14
    schedule_steps: int = 50000
    lmbda_a: float = 0.1 * 2.0**-6
    lmbda_b: float = 0.1 * 2.0**1
    use_gan: bool = True


_CONFIGS = {
    # The reference configs.py: 'hific' = GAN training, 'mselpips' =
    # distortion and perceptual loss only.
    "hific": HiFiCConfig(use_gan=True),
    "mselpips": HiFiCConfig(use_gan=False, CP=0.0),
}


def get_config(config_name: str) -> HiFiCConfig:
    if config_name not in _CONFIGS:
        raise ValueError(
            f"Unknown config_name={config_name} not in "
            f"{sorted(_CONFIGS)}")
    return _CONFIGS[config_name]


def valid_configs():
    return sorted(_CONFIGS)


def same_pads(n, kernel, stride):
    """(before, after) padding of flax / XLA "SAME" on an axis of n."""
    total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def _lecun_kernel(shape, generator):
    """flax's default kernel init: a normal truncated to two standard
    deviations, of variance 1 / fan_in (HWIO)."""
    kernel = torch.empty(shape)
    nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # std of the standard normal truncated to (-2, 2).
    return kernel * (1.0 / math.prod(shape[:-1])) ** 0.5 / 0.87962566103423978


def overlap_add(x, kernel, bias, stride):
    """flax's ``nn.ConvTranspose`` (padding "SAME", s <= k - 1) of an NCHW
    tensor by an HWIO kernel, as one fp32 matrix product over the input's
    positions and an overlap-add: the kernel, flipped and viewed as an
    (O k k, C) matrix, times the input's (C, H W) columns gives each
    position's k x k patch of every output channel, and ``F.fold`` sums the
    patches at stride s into the (s (H - 1) + k)^2 output, of which flax
    keeps s H x s W.  The fold gathers: each output value adds its at most
    ceil(k / s)^2 patches in a fixed order, with no atomics, so equal
    inputs give equal outputs."""
    global GEMM_UPSAMPLES
    k, s = kernel.shape[0], stride
    n, c, h, w = x.shape
    # XLA pads the dilated input by ceil((k + s - 2) / 2) before; the
    # transposed convolution's output o is flax's o - (k - 1 - that).
    skip = k - 1 - math.ceil((k + s - 2) / 2)
    cols = torch.matmul(kernel.flip(0, 1).permute(3, 0, 1, 2).reshape(-1, c),
                        x.reshape(n, c, h * w))
    out = F.fold(cols, (s * (h - 1) + k, s * (w - 1) + k), k, stride=s)
    GEMM_UPSAMPLES += 1
    return (out[:, :, skip: skip + s * h, skip: skip + s * w]
            + bias.view(1, -1, 1, 1))


class Conv(nn.Module):
    """flax ``nn.Conv(filters, (k, k), strides=(s, s), padding="SAME")``
    on NCHW tensors; ``kernel`` is HWIO, as flax stores it."""

    def __init__(self, in_channels, filters, kernel_size, stride=1,
                 generator=None):
        super().__init__()
        self.kernel_size, self.stride = int(kernel_size), int(stride)
        self.kernel = nn.Parameter(_lecun_kernel(
            (kernel_size, kernel_size, in_channels, filters), generator))
        self.bias = nn.Parameter(torch.zeros(filters))

    def forward(self, x, kernel=None):
        """``kernel``, when given, stands in for ``self.kernel`` (the
        spectral norm's normalized one)."""
        k, s = self.kernel_size, self.stride
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        x = F.pad(x, (left, right, top, bottom))
        kernel = self.kernel if kernel is None else kernel
        return F.conv2d(x, kernel.permute(3, 2, 0, 1), self.bias, stride=s)

    def gemm(self, x):
        """The same convolution of an NHWC tensor, for stride 1, as one
        fp32 matrix product: the k x k shifted windows of the "SAME"-padded
        input as an (N H W, k k C) patch matrix in (kh, kw, c) order, times
        the HWIO kernel viewed as its (k k C, O) matrix; NHWC out."""
        global GEMM_CONVS
        k = self.kernel_size
        n, h, w, c = x.shape
        top, bottom = same_pads(h, k, 1)
        left, right = same_pads(w, k, 1)
        x = F.pad(x, (0, 0, left, right, top, bottom))
        # (N, H, W, C, kh, kw) windows -> (N H W, kh kw C) rows.
        patches = x.unfold(1, k, 1).unfold(2, k, 1).permute(
            0, 1, 2, 4, 5, 3).reshape(n * h * w, k * k * c)
        GEMM_CONVS += 1
        return torch.addmm(self.bias, patches, self.kernel.reshape(
            k * k * c, -1)).view(n, h, w, -1)

    def overlap_add(self, x):
        """The same convolution of an NCHW tensor, for stride 1, as the
        transposed convolution of the same kernel (at stride 1 flax's two
        agree), run by ``overlap_add``."""
        return overlap_add(x, self.kernel, self.bias, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(filters, (k, k), strides=(s, s),
    padding="SAME")`` on NCHW tensors (output s times the input), for
    s <= k - 1; ``kernel`` is HWIO, as flax stores it."""

    def __init__(self, in_channels, filters, kernel_size, stride,
                 generator=None):
        super().__init__()
        if not 1 <= stride <= kernel_size - 1:
            raise NotImplementedError("ConvTranspose needs s <= k - 1")
        self.kernel_size, self.stride = int(kernel_size), int(stride)
        self.kernel = nn.Parameter(_lecun_kernel(
            (kernel_size, kernel_size, in_channels, filters), generator))
        self.bias = nn.Parameter(torch.zeros(filters))

    def forward(self, x):
        return overlap_add(x, self.kernel, self.bias, self.stride)


class ChannelNorm(nn.Module):
    """Normalizes over the channels (``dim``: 1 for NCHW, -1 for NHWC) with
    the unbiased variance, then ``gamma`` and ``beta``; the mean inside the
    variance carries no gradient (the JAX package's stop_gradient)."""

    def __init__(self, channels, epsilon=1e-3):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, dim=1):
        c = x.shape[dim]
        mean = torch.mean(x, dim=dim, keepdim=True)
        var = torch.sum(torch.square(x - mean.detach()), dim=dim,
                        keepdim=True) / (c - 1)
        shape = [1] * x.ndim
        shape[dim] = c
        return ((x - mean) * torch.rsqrt(var + self.epsilon)
                * self.gamma.view(shape) + self.beta.view(shape))


class ResidualBlock(nn.Module):
    """x + ChannelNorm(conv3x3(relu(ChannelNorm(conv3x3(x))))) on NHWC
    tensors, each convolution one matrix product (``Conv.gemm``)."""

    def __init__(self, filters, kernel_size=3, generator=None):
        super().__init__()
        self.Conv_0 = Conv(filters, filters, kernel_size, generator=generator)
        self.ChannelNorm_0 = ChannelNorm(filters)
        self.Conv_1 = Conv(filters, filters, kernel_size, generator=generator)
        self.ChannelNorm_1 = ChannelNorm(filters)

    def forward(self, x):
        h = F.relu(self.ChannelNorm_0(self.Conv_0.gemm(x), dim=-1))
        return x + self.ChannelNorm_1(self.Conv_1.gemm(h), dim=-1)


# The layers carry flax's auto-names (Conv_i, ChannelNorm_i, ...), so the
# state dict's names are the flax tree's joined with dots.
class Encoder(nn.Module):
    """conv7x7, ChannelNorm, relu, then num_down x (conv3x3 s2 doubling
    the filters, ChannelNorm, relu), then conv3x3 to the bottleneck
    (NCHW)."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        base = cfg.num_filters_base
        self.num_down = cfg.num_down
        self.Conv_0 = Conv(3, base, 7, generator=generator)
        self.ChannelNorm_0 = ChannelNorm(base)
        for i in range(cfg.num_down):
            setattr(self, f"Conv_{i + 1}", Conv(
                base * 2**i, base * 2 ** (i + 1), 3, stride=2,
                generator=generator))
            setattr(self, f"ChannelNorm_{i + 1}",
                    ChannelNorm(base * 2 ** (i + 1)))
        setattr(self, f"Conv_{cfg.num_down + 1}", Conv(
            base * 2**cfg.num_down, cfg.num_filters_bottleneck, 3,
            generator=generator))

    def forward(self, x):
        for i in range(self.num_down + 1):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"ChannelNorm_{i}")(x))
        return getattr(self, f"Conv_{self.num_down + 1}")(x)


class Decoder(nn.Module):
    """The generator: ChannelNorm, conv3x3, ChannelNorm (the head), the
    residual blocks plus the head, num_down x (transposed conv3x3 s2
    halving the filters, ChannelNorm, relu), conv7x7 to three channels
    (NHWC in and out).

    The trunk (the head and the blocks) stays NHWC and runs its stride-1
    convolutions as fp32 matrix products (``Conv.gemm``): at batch 1 on
    the latent grid cuDNN's deterministic heuristic gives its 960-channel
    convolutions a small implicit-GEMM tile, and each call copies the HWIO
    kernel to OIHW (on an NVIDIA H100 80GB HBM3 at 700 W, 768x512: the
    trunk 22.2 ms through cuDNN, 13.9 ms as GEMMs).  The upsampling stack
    runs on an NCHW view, each transposed convolution and the 7x7 tail one
    fp32 matrix product and an overlap-add (``overlap_add``): for the
    transposed convolutions at batch 1 deterministic cuDNN picks its FFT
    engine, a GEMV a frequency bin and a 9 GB workspace (on the same card:
    the four and the tail 39.1 ms through cuDNN, 4.2 ms so)."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        base, bottleneck = cfg.num_filters_base, cfg.num_filters_bottleneck
        top = base * 2**cfg.num_down
        self.num_down = cfg.num_down
        self.num_residual_blocks = cfg.num_residual_blocks
        self.ChannelNorm_0 = ChannelNorm(bottleneck)
        self.Conv_0 = Conv(bottleneck, top, 3, generator=generator)
        self.ChannelNorm_1 = ChannelNorm(top)
        for i in range(cfg.num_residual_blocks):
            setattr(self, f"block_{i}", ResidualBlock(top,
                                                      generator=generator))
        filters = top
        for j, scale in enumerate(reversed(range(cfg.num_down))):
            setattr(self, f"ConvTranspose_{j}", ConvTranspose(
                filters, base * 2**scale, 3, 2, generator=generator))
            setattr(self, f"ChannelNorm_{j + 2}", ChannelNorm(
                base * 2**scale))
            filters = base * 2**scale
        self.Conv_1 = Conv(filters, 3, 7, generator=generator)

    def forward(self, y):
        head = self.ChannelNorm_1(
            self.Conv_0.gemm(self.ChannelNorm_0(y, dim=-1)), dim=-1)
        h = head
        for i in range(self.num_residual_blocks):
            h = getattr(self, f"block_{i}")(h)
        h = (h + head).permute(0, 3, 1, 2)
        for j in range(self.num_down):
            h = getattr(self, f"ConvTranspose_{j}")(h)
            h = F.relu(getattr(self, f"ChannelNorm_{j + 2}")(h))
        return self.Conv_1.overlap_add(h).permute(0, 2, 3, 1)


class HyperAnalysis(nn.Module):
    """SignalConv 3x3, relu, 5x5 s2, relu, 5x5 s2, RDFT kernels, biases
    (NCHW); takes y as it is."""

    def __init__(self, in_channels, num_filters=320, generator=None):
        super().__init__()
        for i, (support, stride) in enumerate(((3, 1), (5, 2), (5, 2))):
            setattr(self, f"layer_{i}", SignalConv2D(
                in_channels if i == 0 else num_filters, num_filters, support,
                corr=True, strides_down=stride,
                padding="same_zeros", use_bias=True,
                generator=generator))

    def forward(self, y):
        y = F.relu(self.layer_0(y))
        y = F.relu(self.layer_1(y))
        return self.layer_2(y)


class HyperSynthesis(nn.Module):
    """SignalConv 5x5 up 2, relu, 5x5 up 2, relu, 3x3 to the bottleneck,
    plain kernels, biases (NCHW)."""

    def __init__(self, num_filters=320, bottleneck=220, generator=None):
        super().__init__()
        for i, (filters, support, up) in enumerate((
                (num_filters, 5, 2), (num_filters, 5, 2), (bottleneck, 3, 1))):
            setattr(self, f"layer_{i}", SignalConv2D(
                num_filters, filters, support, corr=False, strides_up=up,
                padding="same_zeros", use_bias=True,
                kernel_parameter="variable",
                generator=generator))

    def forward(self, z):
        z = F.relu(self.layer_0(z))
        z = F.relu(self.layer_1(z))
        return self.layer_2(z)


class SpectralNorm(nn.Module):
    """flax ``nn.SpectralNorm`` around one convolution: maps its HWIO
    kernel, viewed as a matrix W of (kh kw cin, cout), to W / sigma.

    Each call takes one power step from the stored ``u`` (1, cout):
    v = l2n(u W^T), u' = l2n(v W), with l2n(x) = x rsqrt(sum x^2 + eps);
    u' and v carry no gradient, sigma = v W u'^T does.  The step runs
    whether or not ``update_stats`` is set; the flag only decides whether
    u' and sigma are stored.  The stored sigma is never read (flax keeps it
    too).  ``u`` starts as a standard normal draw, ``sigma`` as one.
    """

    def __init__(self, features, generator=None, epsilon=1e-12):
        super().__init__()
        self.epsilon = float(epsilon)
        self.register_buffer("u", torch.randn((1, features),
                                              generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def _l2n(self, x):
        return x * torch.rsqrt(torch.sum(x * x) + self.epsilon)

    def forward(self, kernel, update_stats=True):
        mat = kernel.reshape(-1, kernel.shape[-1])
        with torch.no_grad():
            v = self._l2n(self.u @ mat.T)
            u = self._l2n(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return (mat / torch.where(sigma != 0, sigma, 1.0)).reshape(
            kernel.shape)


class Discriminator(nn.Module):
    """Latent-conditioned patch discriminator with spectral norm (NHWC in):
    an SN 3x3 conv of the latent to 12 channels and leaky relu 0.2, a
    nearest upsampling by 2^num_down cropped to the image, the image and
    that concatenated, SN 4x4 stride-2 convs of doubling width (capped at
    512) with leaky relu, an SN 4x4 stride-1 conv and leaky relu, an SN 4x4
    conv to one logit a patch; returns the logits [-1, 1] in NHWC order.

    Convolution ``i`` is ``Conv_i`` and its power-iteration state
    ``SpectralNorm_i`` (flax's names; ``disc_params_from_jax``).
    """

    def __init__(self, latent_channels, num_filters_base=64, num_layers=3,
                 num_down=4, seed=0):
        super().__init__()
        self.num_down = int(num_down)
        gen = torch.Generator().manual_seed(int(seed))
        specs = [(latent_channels, 12, 3, 1), (3 + 12, num_filters_base, 4, 2)]
        filters = num_filters_base
        for _ in range(num_layers - 1):
            specs.append((filters, min(filters * 2, 512), 4, 2))
            filters = min(filters * 2, 512)
        specs.append((filters, min(filters * 2, 512), 4, 1))
        specs.append((min(filters * 2, 512), 1, 4, 1))
        self.num_convs = len(specs)
        for i, (cin, cout, k, stride) in enumerate(specs):
            setattr(self, f"Conv_{i}", Conv(cin, cout, k, stride,
                                            generator=gen))
            setattr(self, f"SpectralNorm_{i}", SpectralNorm(cout,
                                                            generator=gen))

    def _sn_conv(self, i, h, update_stats):
        conv = getattr(self, f"Conv_{i}")
        kernel = getattr(self, f"SpectralNorm_{i}")(conv.kernel, update_stats)
        return conv(h, kernel)

    def forward(self, x, latent, update_stats=True):
        x = x.permute(0, 3, 1, 2)
        lat = F.leaky_relu(self._sn_conv(0, latent.permute(0, 3, 1, 2),
                                         update_stats), 0.2)
        # jax.image.resize "nearest" at an integer factor repeats.
        factor = 2**self.num_down
        lat = lat.repeat_interleave(factor, 2).repeat_interleave(factor, 3)
        h = torch.cat([x, lat[:, :, : x.shape[2], : x.shape[3]]], dim=1)
        for i in range(1, self.num_convs - 1):
            h = F.leaky_relu(self._sn_conv(i, h, update_stats), 0.2)
        logits = self._sn_conv(self.num_convs - 1, h, update_stats)
        return logits.permute(0, 2, 3, 1).reshape(-1, 1)


def _nhwc(module, x):
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class HiFiCModel(nn.Module):
    """The generator and the probability model, with the inference
    sub-graphs the codec runs (encode, hyper_decode, scale_indexes,
    decode); weights from a seeded init (``seed``) or carried over with
    ``params_from_jax``."""

    num_scales = SCALES_LEVELS

    def __init__(self, cfg: HiFiCConfig = HiFiCConfig(), seed=0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(int(seed))
        self.encoder = Encoder(cfg, generator=gen)
        self.decoder = Decoder(cfg, generator=gen)
        self.hyper_analysis = HyperAnalysis(
            cfg.num_filters_bottleneck, cfg.hyper_filters, generator=gen)
        self.hyper_synthesis_scale = HyperSynthesis(
            cfg.hyper_filters, cfg.num_filters_bottleneck, generator=gen)
        self.hyper_synthesis_mean = HyperSynthesis(
            cfg.hyper_filters, cfg.num_filters_bottleneck, generator=gen)
        prior = deep_factorized.DeepFactorized.init_params(
            (cfg.hyper_filters,), generator=gen)
        self.hyperprior_matrices = nn.ParameterList(prior["matrices"])
        self.hyperprior_biases = nn.ParameterList(prior["biases"])
        self.hyperprior_factors = nn.ParameterList(prior["factors"])

    @property
    def latent_depth(self):
        """Depth of y, read off the encoder's last convolution."""
        return int(getattr(self.encoder,
                           f"Conv_{self.cfg.num_down + 1}").kernel.shape[-1])

    def hyperprior(self, device=None):
        """NoisyDeepFactorized hyperprior over z, over the parameters
        themselves, or over detached copies on ``device`` when it is given
        (the codec's tables)."""
        def get(plist):
            return [p if device is None else p.detach().to(device)
                    for p in plist]
        return deep_factorized.NoisyDeepFactorized(
            params={"matrices": get(self.hyperprior_matrices),
                    "biases": get(self.hyperprior_biases),
                    "factors": get(self.hyperprior_factors)},
            batch_shape=(self.cfg.hyper_filters,))

    @staticmethod
    def scale_fn():
        return make_scale_fn(SCALES_MIN, SCALES_MAX, SCALES_LEVELS)

    @staticmethod
    def scale_indexes(raw_scales):
        """Continuous scale-table indexes of exp(raw_scales): the clipped
        scale's position between log SCALES_MIN and log SCALES_MAX, times
        SCALES_LEVELS - 1 (the JAX package's float32 constants)."""
        log_min = np.float32(np.log(SCALES_MIN))
        span = np.float32(np.log(SCALES_MAX) - np.log(SCALES_MIN))
        s = torch.clamp(torch.exp(raw_scales), SCALES_MIN, SCALES_MAX)
        return (torch.log(s) - float(log_min)) / float(span) * (
            SCALES_LEVELS - 1)

    def forward(self, x, training=True, generator=None, u=None):
        """Returns (x_hat, y_hat, nbpp, qbpp) for a uint8/float NHWC batch:
        the generator's image of y_hat (0-255 scale, not cropped), y rounded
        about the predicted means with a straight-through gradient, and the
        bits per pixel with y noisy (``training``) and with y quantized.

        In training mode z and y are perturbed with U(-.5, .5) noise: from
        ``generator`` (on ``x``'s device; z's draw first, then y's) or given
        as ``u = (u_z, u_y)`` (the JAX package draws z's from
        ``jax.random.split(key, 1)[0]`` and y's from ``key``).
        """
        x = torch.as_tensor(x).to(torch.float32)
        u_z, u_y = (None, None) if u is None else u
        em_z = ContinuousBatchedEntropyModel(
            prior=self.hyperprior(), coding_rank=3, compression=False,
            offset_heuristic=False, device=x.device)
        em_y = LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, SCALES_LEVELS, self.scale_fn(),
            coding_rank=3, compression=False, device=x.device)
        y, z = self.encode(x)
        _, z_bits = em_z(z, training=training, generator=generator, u=u_z)
        raw_scales, means = self.hyper_decode(em_z.quantize(z))
        raw_scales = raw_scales[:, : y.shape[1], : y.shape[2], :]
        means = means[:, : y.shape[1], : y.shape[2], :]
        indexes = self.scale_indexes(raw_scales)
        # The noisy rate (differentiable) and the quantized one (the true
        # bit count).
        _, y_bits_noisy = em_y(y, indexes, loc=means, training=training,
                               generator=generator, u=u_y)
        _, y_bits_q = em_y(y, indexes, loc=means, training=False)
        y_hat = round_ops.round_st(y - means) + means
        x_hat = self.decode(y_hat)
        num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
        nbpp = (torch.sum(y_bits_noisy) + torch.sum(z_bits)) / num_pixels
        qbpp = (torch.sum(y_bits_q) + torch.sum(z_bits)) / num_pixels
        return x_hat, y_hat, nbpp, qbpp

    # Inference sub-graphs (the JAX package's methods of the same names).
    def encode(self, x):
        """uint8/float NHWC image batch -> (y, z)."""
        x = torch.as_tensor(x).to(torch.float32) / 255.0 * 2.0 - 1.0
        y = _nhwc(self.encoder, x)
        return y, _nhwc(self.hyper_analysis, y)

    def hyper_decode(self, z_hat):
        """(raw scales, latent means) of a quantized hyper-latent."""
        return (_nhwc(self.hyper_synthesis_scale, z_hat),
                _nhwc(self.hyper_synthesis_mean, z_hat))

    def decode(self, y_hat):
        """y_hat -> the generator's image scaled to [0, 255] (unclipped)."""
        return (self.decoder(y_hat) + 1.0) / 2.0 * 255.0


def params_from_jax(tree) -> dict:
    """Converts JAX ``HiFiCModel`` params (the flax dict, as numpy or jax
    arrays, with or without the top-level "params" key) to this model's
    state_dict: the flax tree's nested names joined with dots, the
    hyperprior's lists as ``hyperprior_{matrices,biases,factors}.i``."""
    tree = tree.get("params", tree)
    state = {}

    def walk(prefix, node):
        for key, value in node.items():
            if hasattr(value, "items"):
                walk(f"{prefix}{key}.", value)
            else:
                state[prefix + key] = torch.tensor(
                    np.asarray(value, np.float32))

    for part, sub in tree.items():
        if part != "hyperprior":
            walk(f"{part}.", sub)
    for key in ("matrices", "biases", "factors"):
        for i, value in enumerate(tree["hyperprior"][key]):
            state[f"hyperprior_{key}.{i}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state


def disc_params_from_jax(variables) -> dict:
    """Converts a JAX ``Discriminator``'s variables (``params`` and
    ``batch_stats``, as numpy or jax arrays) to this Discriminator's
    state_dict: ``params/Conv_i/{kernel,bias}`` to ``Conv_i.*`` and
    ``batch_stats/SpectralNorm_i/"Conv_i/kernel/{u,sigma}"`` to
    ``SpectralNorm_i.{u,sigma}``."""
    state = {}
    for name, leaves in variables["params"].items():
        for key, value in leaves.items():
            state[f"{name}.{key}"] = torch.tensor(np.asarray(value,
                                                             np.float32))
    for name, leaves in variables["batch_stats"].items():
        for key, value in leaves.items():
            state[f"{name}.{key.rsplit('/', 1)[1]}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state


def _scheduled(initial, final, step, schedule_steps):
    """Two-phase schedule: ``initial`` before ``schedule_steps``, then
    ``final``."""
    return initial if step < schedule_steps else final


def rd_loss(cfg: HiFiCConfig, distortion, nbpp, qbpp, step):
    """Rate-targeted RD loss (the reference's _LossScaler.get_rd_loss):
    the rate weighed by 1 / lmbda_a above the scheduled target and by
    1 / lmbda_b below it.  The constants are float32 products, as in the
    JAX package; ``step`` is a Python int."""
    f32 = np.float32
    target = f32(cfg.target) * f32(_scheduled(
        cfg.target_factor_initial, 1.0, step, cfg.schedule_steps))
    factor = f32(_scheduled(2.0, 1.0, step, cfg.schedule_steps))
    lmbda_a = f32(cfg.lmbda_a) * factor
    lmbda_b = f32(cfg.lmbda_b) * factor
    lmbda_inv = torch.where(torch.as_tensor(qbpp) > float(target),
                            float(f32(1.0) / lmbda_a),
                            float(f32(1.0) / lmbda_b))
    weighted_rate = lmbda_inv * nbpp * cfg.C
    weighted_distortion = distortion * cfg.CD * cfg.C
    return weighted_rate + weighted_distortion


def make_train_steps(model: HiFiCModel, disc: Optional[Discriminator],
                     g_optimizer, d_optimizer=None,
                     perceptual_loss_fn: Optional[Callable] = None,
                     lpips_weights_path: Optional[str] = None):
    """Returns ``(g_step, d_step)``; ``d_step`` is None without ``disc``.

    ``g_step(batch, step, generator=None, u=None)`` updates the generator
    (all of ``model``'s parameters) on the MSE (0-255 scale) and
    ``rd_loss``, plus ``cfg.CP`` times the perceptual loss, plus ``cfg.CP``
    times mean(softplus(-logits)) of the discriminator's current state on
    (x_hat / 255, y_hat detached) without storing its power step.
    ``d_step(batch, generator=None, u=None)`` runs the generator again
    without a gradient (its own noise), takes the real and the fake
    logits from the same stored ``u``, keeps the real pass's power step,
    and updates only the discriminator on mean(softplus(-real)) +
    mean(softplus(fake)).  ``generator`` or ``u`` is the training noise
    (``HiFiCModel.forward``).  Batches are uint8/float NHWC, moved to the
    model's device; the steps return their metrics as 0-d tensors there.

    The perceptual loss defaults, when ``cfg.CP > 0``, to LPIPS of
    (x / 255, x_hat / 255) (``lpips.make_lpips_loss``: the weights at
    ``lpips_weights_path`` when that file exists, else the random ones);
    ``perceptual_loss_fn(x, x_hat) -> scalar`` overrides it.
    """
    cfg = model.cfg
    g_params = list(model.parameters())
    device = g_params[0].device
    if perceptual_loss_fn is None and cfg.CP > 0:
        _lpips = lpips_lib.make_lpips_loss(lpips_weights_path, device=device)
        perceptual_loss_fn = lambda x, x_hat: _lpips(x / 255.0,
                                                     x_hat / 255.0)

    def g_step(batch, step, generator=None, u=None):
        x = torch.as_tensor(batch, device=device).to(torch.float32)
        x_hat, y_hat, nbpp, qbpp = model(x, training=True,
                                         generator=generator, u=u)
        distortion = torch.mean(torch.square(x - x_hat))
        loss = rd_loss(cfg, distortion, nbpp, qbpp, step)
        if perceptual_loss_fn is not None:
            loss = loss + cfg.CP * perceptual_loss_fn(x, x_hat)
        if disc is not None:
            logits_fake = disc(x_hat / 255.0, y_hat.detach(),
                               update_stats=False)
            # The non-saturating generator loss.
            loss = loss + cfg.CP * torch.mean(F.softplus(-logits_fake))
        # The generator's gradient only (the discriminator's is not taken).
        grads = torch.autograd.grad(loss, g_params)
        for p, g in zip(g_params, grads):
            p.grad = g
        g_optimizer.step()
        return {"g_loss": loss.detach(), "nbpp": nbpp.detach(),
                "qbpp": qbpp.detach(), "distortion": distortion.detach()}

    if disc is None:
        return g_step, None

    def d_step(batch, generator=None, u=None):
        x = torch.as_tensor(batch, device=device).to(torch.float32)
        with torch.no_grad():
            x_hat, y_hat, _, _ = model(x, training=True, generator=generator,
                                       u=u)
        d_optimizer.zero_grad(set_to_none=True)
        # The fake pass first, on the stored u; the real pass then takes
        # its power step from the same u and stores it.
        logits_fake = disc(x_hat / 255.0, y_hat, update_stats=False)
        logits_real = disc(x / 255.0, y_hat, update_stats=True)
        loss = torch.mean(F.softplus(-logits_real)) + torch.mean(
            F.softplus(logits_fake))
        loss.backward()
        d_optimizer.step()
        return {"d_loss": loss.detach()}

    return g_step, d_step


def train(config: HiFiCConfig = HiFiCConfig(), steps=1000, batch_size=2,
          patchsize=256, learning_rate=1e-4, data_iter=None, seed=0,
          num_steps_disc=1, log_every=100, init_params=None,
          lpips_weights_path=None, device="cuda"):
    """Two-optimizer GAN training loop (the reference's model.py
    build_model); returns ``(model, disc)``, disc None without the GAN.

    Each step runs the g step, then ``num_steps_disc`` d steps, each with
    Adam at ``learning_rate``.  ``init_params`` (a state_dict) warm-starts
    the generator (the reference's ``--init_autoencoder_from_ckpt_dir``).
    ``data_iter`` yields uint8/float NHWC batches; if None, random noise
    patches from ``np.random.RandomState(seed)`` are used (the JAX
    package's batches).  The weights come from ``seed`` and the noise from
    a generator on ``device`` seeded with it.  Runs on the card unless the
    caller passes device="cpu"; convolutions follow torch.backends' TF32
    flags.
    """
    device = resolve_device(device)
    model = HiFiCModel(config, seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params)
    model.to(device)
    disc = d_opt = None
    g_opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    if config.use_gan:
        disc = Discriminator(model.latent_depth, seed=seed).to(device)
        d_opt = torch.optim.Adam(disc.parameters(), lr=learning_rate)
    g_step, d_step = make_train_steps(
        model, disc, g_opt, d_opt, lpips_weights_path=lpips_weights_path)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def default_iter():
        rng = np.random.RandomState(seed)
        while True:
            yield rng.randint(
                0, 256, (batch_size, patchsize, patchsize, 3)).astype(
                    np.float32)

    it = data_iter if data_iter is not None else default_iter()
    for step, batch in zip(range(steps), it):
        metrics = g_step(batch, step, generator=generator)
        if disc is not None:
            for _ in range(num_steps_disc):
                metrics.update(d_step(batch, generator=generator))
        if log_every and step % log_every == 0:
            msg = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            print(f"step {step}: {msg}", flush=True)
    return model, disc


class HiFiCCodec(BMSHJ2018Codec):
    """Inference codec with frozen tables for both entropy models:
    ``bmshj2018.BMSHJ2018Codec`` with y coded about the mean branch's
    prediction and its scale indexes from the scale branch.

    Args:
      model: a HiFiCModel (moved to ``device``).
      device: where the codec runs; "cuda" unless the caller asks for the
        CPU.  On CUDA the range coder runs the hand-written kernels.
      tables: optional carried entropy-model weights, as BMSHJ2018Codec
        takes them; by default the y table is built from the scale
        function and the z table from the model's hyperprior, with the
        quantization offset the prior gives.

    The float path runs in full float32 (TF32 off, cuDNN deterministic;
    the generator as fp32 matrix products, the upsampling stack's with a
    gathering overlap-add, ``Decoder``), so that
    ``decompress(compress(x))`` and ``decompress(compress_native(x))``
    equal ``reconstruct(x)`` exactly.
    """

    MODEL_ID = "hific"

    def _y_params(self, z_hat, y_hw):
        """(continuous scale indexes, means) of y, cropped to y."""
        with profiling.span("transforms", "hyper_synthesis", "dispatch"):
            raw_scales, means = self.model.hyper_decode(z_hat)
        raw_scales = raw_scales[:, : y_hw[0], : y_hw[1], :]
        means = means[:, : y_hw[0], : y_hw[1], :]
        return self.model.scale_indexes(raw_scales), means

    def _quantized_latent(self, x):
        """y rounded about the means the quantized hyper-latent gives."""
        y, _, _, means = self._encode(x)
        return self.em.quantize(y, means)


def model_from_config(config, seed=0) -> HiFiCModel:
    """The model a checkpoint of ``main`` describes: the named config
    ("hific" by default) with the saved target, weights from ``seed``."""
    cfg = get_config(config.get("config", "hific"))
    if config.get("target") is not None:
        cfg = cfg._replace(target=config["target"])
    return HiFiCModel(cfg, seed=seed)


def main(argv=None):
    """HiFiC's command line: train / compress / decompress.

    Mirrors the reference entry points (models/hific/train.py flags
    --config/--num_steps/--batch_size/--crop_size/--num_steps_disc/
    --init_autoencoder_from_ckpt_dir/--lpips_weight_path; evaluate.py for
    the inference side) as subcommands of one tool.  ``train`` saves the
    generator's state_dict with ``util.checkpoint``; ``compress`` writes
    the classic container.  Every subcommand runs on the card unless
    ``--device cpu`` is given.
    """
    import argparse

    from compression_tpu_torch.util import checkpoint as ckpt_lib
    from compression_tpu_torch.util import datasets

    parser = argparse.ArgumentParser(
        prog="hific", description="HiFiC codec (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="Train a HiFiC model.")
    t.add_argument("--config", default="hific", choices=valid_configs(),
                   help="'hific' = GAN training, 'mselpips' = no GAN.")
    t.add_argument("--model_path", default="hific_ckpt")
    t.add_argument("--train_glob", default=None,
                   help="Glob/directory of training images; default = "
                        "synthetic noise (smoke run).")
    t.add_argument("--num_steps", type=int, default=10000)
    t.add_argument("--batchsize", type=int, default=2)
    t.add_argument("--patchsize", type=int, default=256)
    t.add_argument("--learning_rate", type=float, default=1e-4)
    t.add_argument("--num_steps_disc", type=int, default=1)
    t.add_argument("--target", type=float, default=None,
                   help="Override the config's target bpp.")
    t.add_argument("--lpips_weights_path", default=None,
                   help="Local VGG/LPIPS npz (nothing is downloaded).")
    t.add_argument("--warm_start", default=None,
                   help="Checkpoint dir to initialize the generator from "
                        "(reference --init_autoencoder_from_ckpt_dir).")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda")

    for name in ("compress", "decompress"):
        c = sub.add_parser(name)
        c.add_argument("--model_path", default="hific_ckpt")
        c.add_argument("--device", default="cuda")
        c.add_argument("input_file")
        c.add_argument("output_file", nargs="?")

    args = parser.parse_args(argv)

    if args.command == "train":
        cfg = get_config(args.config)
        if args.target is not None:
            cfg = cfg._replace(target=args.target)
        init_params = None
        if args.warm_start:
            payload, _ = ckpt_lib.load_checkpoint(args.warm_start)
            init_params = payload["params"]
        data_iter = None
        if args.train_glob:
            data_iter = datasets.image_patch_iterator(
                args.train_glob, args.batchsize, args.patchsize, args.seed)
        model, _ = train(
            cfg, steps=args.num_steps, batch_size=args.batchsize,
            patchsize=args.patchsize, learning_rate=args.learning_rate,
            data_iter=data_iter, seed=args.seed,
            num_steps_disc=args.num_steps_disc, init_params=init_params,
            lpips_weights_path=args.lpips_weights_path, device=args.device)
        ckpt_lib.save_checkpoint(
            args.model_path, model.state_dict(),
            config={"model_name": "hific", "config": args.config,
                    "target": cfg.target})
        print(f"saved checkpoint to {args.model_path}")
        return

    payload, config = ckpt_lib.load_checkpoint(args.model_path)
    model = model_from_config(config or {})
    model.load_state_dict(payload["params"])
    codec = HiFiCCodec(model, device=args.device)

    if args.command == "compress":
        img = datasets.load_image(args.input_file)
        container = codec.compress(img)
        out = args.output_file or args.input_file + ".tfci"
        with open(out, "wb") as f:
            f.write(container)
        bpp = len(container) * 8 / (img.shape[0] * img.shape[1])
        print(f"{out}: {len(container)} bytes, {bpp:.4f} bpp")
    else:
        with open(args.input_file, "rb") as f:
            container = f.read()
        img = codec.decompress(container)
        out = args.output_file or args.input_file + ".png"
        datasets.save_image(out, img)
        print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")


if __name__ == "__main__":
    main()
