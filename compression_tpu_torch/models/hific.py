"""HiFiC: High-Fidelity Generative Image Compression (Mentzer et al. 2020):
its serving path (PyTorch counterpart of compression_tpu/models/hific.py).

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
the JAX package's codec.  The GAN training half (discriminator, losses,
train steps) is not ported.  Weights come from a seeded init or from the
JAX package (``params_from_jax``).  Images are uint8 [H, W, 3] (numpy or
torch), latents [1, H, W, C], the JAX package's NHWC layout; images enter
the encoder as x / 255 * 2 - 1 and leave the generator as (x + 1) / 2 *
255.

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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.layers.signal_conv import SignalConv2D
from compression_tpu_torch.models.bmshj2018 import (BMSHJ2018Codec,
                                                    make_scale_fn)

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
    "params_from_jax",
]

SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64


class HiFiCConfig(NamedTuple):
    """Mirrors the reference 'hific' config (configs.py:20-48)."""

    num_down: int = 4
    num_filters_base: int = 60
    num_filters_bottleneck: int = 220
    num_residual_blocks: int = 9
    hyper_filters: int = 320
    # Loss schedule (for the GAN training, not ported).
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

    def forward(self, x):
        k, s = self.kernel_size, self.stride
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        stride=s)


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
        k, s = self.kernel_size, self.stride
        h, w = x.shape[2], x.shape[3]
        # XLA pads the dilated input by ceil((k + s - 2) / 2) before; the
        # transposed convolution's output o is flax's o - (k - 1 - that).
        skip = k - 1 - math.ceil((k + s - 2) / 2)
        out = F.conv_transpose2d(
            x, self.kernel.flip(0, 1).permute(2, 3, 0, 1), self.bias,
            stride=s)
        return out[:, :, skip: skip + s * h, skip: skip + s * w]


class ChannelNorm(nn.Module):
    """Normalizes over the channels (dim 1, NCHW) with the unbiased
    variance, then ``gamma`` and ``beta``; the mean inside the variance
    carries no gradient (the JAX package's stop_gradient)."""

    def __init__(self, channels, epsilon=1e-3):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        c = x.shape[1]
        mean = torch.mean(x, dim=1, keepdim=True)
        var = torch.sum(torch.square(x - mean.detach()), dim=1,
                        keepdim=True) / (c - 1)
        return ((x - mean) * torch.rsqrt(var + self.epsilon)
                * self.gamma[:, None, None] + self.beta[:, None, None])


class ResidualBlock(nn.Module):
    """x + ChannelNorm(conv3x3(relu(ChannelNorm(conv3x3(x)))))."""

    def __init__(self, filters, kernel_size=3, generator=None):
        super().__init__()
        self.Conv_0 = Conv(filters, filters, kernel_size, generator=generator)
        self.ChannelNorm_0 = ChannelNorm(filters)
        self.Conv_1 = Conv(filters, filters, kernel_size, generator=generator)
        self.ChannelNorm_1 = ChannelNorm(filters)

    def forward(self, x):
        h = F.relu(self.ChannelNorm_0(self.Conv_0(x)))
        return x + self.ChannelNorm_1(self.Conv_1(h))


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
    (NCHW)."""

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
        head = self.ChannelNorm_1(self.Conv_0(self.ChannelNorm_0(y)))
        h = head
        for i in range(self.num_residual_blocks):
            h = getattr(self, f"block_{i}")(h)
        h = h + head
        for j in range(self.num_down):
            h = getattr(self, f"ConvTranspose_{j}")(h)
            h = F.relu(getattr(self, f"ChannelNorm_{j + 2}")(h))
        return self.Conv_1(h)


class HyperAnalysis(nn.Module):
    """SignalConv 3x3, relu, 5x5 s2, relu, 5x5 s2, RDFT kernels, biases
    (NCHW); takes y as it is."""

    def __init__(self, in_channels, num_filters=320, generator=None):
        super().__init__()
        for i, (support, stride) in enumerate(((3, 1), (5, 2), (5, 2))):
            setattr(self, f"layer_{i}", SignalConv2D(
                in_channels if i == 0 else num_filters, num_filters, support,
                corr=True, strides_down=stride, use_bias=True,
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
                use_bias=True, kernel_parameter="variable",
                generator=generator))

    def forward(self, z):
        z = F.relu(self.layer_0(z))
        z = F.relu(self.layer_1(z))
        return self.layer_2(z)


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
        return (_nhwc(self.decoder, y_hat) + 1.0) / 2.0 * 255.0


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

    The float path runs in full float32 (TF32 off, cuDNN deterministic),
    so that ``decompress(compress(x))`` and
    ``decompress(compress_native(x))`` equal ``reconstruct(x)`` exactly.
    """

    MODEL_ID = "hific"

    def _y_params(self, z_hat, y_hw):
        """(continuous scale indexes, means) of y, cropped to y."""
        raw_scales, means = self.model.hyper_decode(z_hat)
        raw_scales = raw_scales[:, : y_hw[0], : y_hw[1], :]
        means = means[:, : y_hw[0], : y_hw[1], :]
        return self.model.scale_indexes(raw_scales), means

    @torch.no_grad()
    def reconstruct(self, x) -> np.ndarray:
        """Reconstruction without the range coder: the quantized
        hyper-latent gives the means, y is rounded about them and
        synthesized; equals decompress(compress(x)) and
        decompress(compress_native(x)) exactly."""
        x = self._upload(x)
        y, _, _, means = self._encode(x)
        y_hat = self.em.quantize(y, means)
        return self._synthesis_u8(y_hat)[0, : x.shape[0], : x.shape[1],
                                         :].cpu().numpy()
