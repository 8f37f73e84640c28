"""Scale-hyperprior image codec (Ballé et al. 2018): its training and
serving paths (PyTorch counterpart of compression_tpu/models/bmshj2018.py).

Four-layer analysis / synthesis transforms (stride 2 each) with GDN, a
hyper-analysis / hyper-synthesis pair that turns the latent ``y`` into a
hyper-latent ``z`` and ``z`` into one scale index per element of ``y``, a
NoisyDeepFactorized hyperprior over ``z`` (batched entropy model) and a
LocationScaleIndexedEntropyModel over ``y`` with a log-spaced scale table.

``BMSHJ2018Codec`` (on ``image_codec.ImageCodec``) writes and reads two
containers: the reference's classic .tfci one (``compress``: one stream for
``y`` and one for ``z``, escapes in-stream; 5 tensors) and the native one
(``compress_native``, ``compress_native_many``: one stream per latent row
block plus an escape sidecar, for both latents; 9 tensors).  ``decompress``
and ``decompress_native_many`` read both, ``reconstruct`` skips the coder.
``BMSHJ2018Model.forward(training=True)`` and ``make_train_step`` train the
model (uniform noise on both latents).  The JAX package's fetch budgets and
compacted transfers, and the fallback that goes with them, have no
counterpart: the escape list here is exact, so ``compress_native`` has no
budget to overflow.  Weights come from a seeded init, from the JAX package
(``params_from_jax``) or from the reference's TF variables
(``params_from_tf``).  Images are uint8 [H, W, 3] (numpy or torch) and
latents [1, H, W, C], the JAX package's NHWC layout.

"Variational image compression with a scale hyperprior"
https://openreview.net/forum?id=rkcQFMZRb
"""

from __future__ import annotations

import math

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
from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.signal_conv import SignalConv2D
from compression_tpu_torch.models import native_format
# One train step serves both models (JAX: models/bmshj2018.py:193).
from compression_tpu_torch.models.bls2017 import make_train_step
from compression_tpu_torch.models.image_codec import ImageCodec
from compression_tpu_torch.util import profiling

__all__ = [
    "AnalysisTransform",
    "SynthesisTransform",
    "HyperAnalysisTransform",
    "HyperSynthesisTransform",
    "BMSHJ2018Model",
    "BMSHJ2018Codec",
    "make_scale_fn",
    "make_train_step",
    "params_from_jax",
    "params_from_tf",
    "CLI_DEFAULTS",
    "model_from_config",
    "main",
]

_TRANSFORMS = (("analysis", 4, "gdn"), ("synthesis", 4, "igdn"),
               ("hyper_analysis", 3, None), ("hyper_synthesis", 3, None))


def make_scale_fn(scale_min, scale_max, num_scales):
    """index -> scale, log-spaced from scale_min to scale_max; the constants
    are Python floats computed as the JAX package computes them, the
    function runs in the indexes' float32."""
    offset = math.log(scale_min)
    factor = (math.log(scale_max) - math.log(scale_min)) / (num_scales - 1.0)
    return lambda i: torch.exp(offset + factor * i)


class AnalysisTransform(nn.Module):
    """x/255 -> three (conv5x5 s2, GDN) -> conv5x5 s2 (NHWC)."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        for i in range(4):
            setattr(self, f"layer_{i}", SignalConv2D(
                3 if i == 0 else nf, nf, 5, corr=True, strides_down=2,
                padding="same_zeros", use_bias=True, generator=generator))
            if i < 3:
                setattr(self, f"gdn_{i}", GDN(nf))

    def forward(self, x):
        x = (x / 255.0).permute(0, 3, 1, 2)
        for i in range(3):
            x = getattr(self, f"gdn_{i}")(getattr(self, f"layer_{i}")(x))
        return self.layer_3(x).permute(0, 2, 3, 1)


class SynthesisTransform(nn.Module):
    """Mirrored upsampling transform with IGDN; output scaled to [0,255]."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        for i in range(4):
            setattr(self, f"layer_{i}", SignalConv2D(
                nf, 3 if i == 3 else nf, 5, corr=False, strides_up=2,
                padding="same_zeros", use_bias=True, generator=generator))
            if i < 3:
                setattr(self, f"igdn_{i}", GDN(nf, inverse=True))

    def forward(self, y):
        y = y.permute(0, 3, 1, 2)
        for i in range(3):
            y = getattr(self, f"igdn_{i}")(getattr(self, f"layer_{i}")(y))
        return (self.layer_3(y) * 255.0).permute(0, 2, 3, 1)


class HyperAnalysisTransform(nn.Module):
    """conv3x3 s1, relu, conv5x5 s2, relu, conv5x5 s2 without bias (NHWC)."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        self.layer_0 = SignalConv2D(nf, nf, 3, corr=True, strides_down=1,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.layer_1 = SignalConv2D(nf, nf, 5, corr=True, strides_down=2,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.layer_2 = SignalConv2D(nf, nf, 5, corr=True, strides_down=2,
                                    padding="same_zeros", use_bias=False,
                                    generator=generator)

    def forward(self, y):
        y = y.permute(0, 3, 1, 2)
        y = F.relu(self.layer_0(y))
        y = F.relu(self.layer_1(y))
        return self.layer_2(y).permute(0, 2, 3, 1)


class HyperSynthesisTransform(nn.Module):
    """Mirror of the hyper analysis; plain (not RDFT) kernels."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        self.layer_0 = SignalConv2D(
            nf, nf, 5, corr=False, strides_up=2,
            padding="same_zeros", use_bias=True,
            kernel_parameter="variable", generator=generator)
        self.layer_1 = SignalConv2D(
            nf, nf, 5, corr=False, strides_up=2,
            padding="same_zeros", use_bias=True,
            kernel_parameter="variable", generator=generator)
        self.layer_2 = SignalConv2D(
            nf, nf, 3, corr=False, strides_up=1,
            padding="same_zeros", use_bias=True,
            kernel_parameter="variable", generator=generator)

    def forward(self, z):
        z = z.permute(0, 3, 1, 2)
        z = F.relu(self.layer_0(z))
        z = F.relu(self.layer_1(z))
        return self.layer_2(z).permute(0, 2, 3, 1)


class BMSHJ2018Model(nn.Module):
    """Rate-distortion model (training and eval forward); weights from a
    seeded init (``seed``) or carried over with ``params_from_jax`` /
    ``params_from_tf``."""

    def __init__(self, lmbda=0.01, num_filters=128, num_scales=64,
                 scale_min=0.11, scale_max=256.0, seed=0):
        super().__init__()
        self.lmbda = float(lmbda)
        self.num_filters = int(num_filters)
        self.num_scales = int(num_scales)
        self.scale_min = float(scale_min)
        self.scale_max = float(scale_max)
        gen = torch.Generator().manual_seed(int(seed))
        self.analysis = AnalysisTransform(num_filters, generator=gen)
        self.synthesis = SynthesisTransform(num_filters, generator=gen)
        self.hyper_analysis = HyperAnalysisTransform(num_filters,
                                                     generator=gen)
        self.hyper_synthesis = HyperSynthesisTransform(num_filters,
                                                       generator=gen)
        prior = deep_factorized.DeepFactorized.init_params(
            (num_filters,), generator=gen)
        self.hyperprior_matrices = nn.ParameterList(prior["matrices"])
        self.hyperprior_biases = nn.ParameterList(prior["biases"])
        self.hyperprior_factors = nn.ParameterList(prior["factors"])

    def scale_fn(self):
        return make_scale_fn(self.scale_min, self.scale_max, self.num_scales)

    @property
    def latent_depth(self):
        """Depth of y, read off the analysis transform rather than assumed
        equal to num_filters."""
        return int(self.analysis.layer_3.filters)

    def hyperprior(self, device=None):
        """NoisyDeepFactorized hyperprior over z, over the parameters
        themselves (what training differentiates), or over detached copies
        on ``device`` when it is given (the codec's tables)."""
        def get(plist):
            return [p if device is None else p.detach().to(device)
                    for p in plist]
        return deep_factorized.NoisyDeepFactorized(
            params={"matrices": get(self.hyperprior_matrices),
                    "biases": get(self.hyperprior_biases),
                    "factors": get(self.hyperprior_factors)},
            batch_shape=(self.num_filters,))

    def forward(self, x, training=False, generator=None, u=None):
        """Returns (loss, bpp, mse) for a uint8/float NHWC batch.

        In training mode both latents are perturbed with U(-.5, .5) noise:
        from ``generator`` (a ``torch.Generator`` on ``x``'s device, which
        draws z's noise first, then y's) or given as ``u = (u_z, u_y)``
        (the latents' shapes; the JAX package splits its key into k1 for z
        and k2 for y).  In eval mode both latents are rounded.
        """
        x = torch.as_tensor(x).to(torch.float32)
        u_z, u_y = (None, None) if u is None else u
        em = LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, self.num_scales, self.scale_fn(),
            coding_rank=3, compression=False, device=x.device)
        side_em = ContinuousBatchedEntropyModel(
            prior=self.hyperprior(), coding_rank=3, compression=False,
            offset_heuristic=False, device=x.device)
        y, z = self.encode(x)
        z_hat, side_bits = side_em(z, training=training, generator=generator,
                                   u=u_z)
        indexes = self.hyper_decode(z_hat)[:, : y.shape[1], : y.shape[2], :]
        y_hat, bits = em(y, indexes, training=training, generator=generator,
                         u=u_y)
        x_hat = self.decode(y_hat)[:, : x.shape[1], : x.shape[2], :]
        num_pixels = int(np.prod(x.shape[:-1]))
        bpp = (torch.sum(bits) + torch.sum(side_bits)) / num_pixels
        mse = torch.mean(torch.square(x - x_hat))
        return bpp + self.lmbda * mse, bpp, mse

    # Inference sub-graphs.
    def encode(self, x):
        y = self.analysis(x)
        return y, self.hyper_analysis(torch.abs(y))

    def hyper_decode(self, z_hat):
        return self.hyper_synthesis(z_hat)

    def decode(self, y_hat):
        return self.synthesis(y_hat)


def _layer_names(n_conv, gdn):
    names = [f"layer_{i}" for i in range(n_conv)]
    if gdn:
        names += [f"{gdn}_{i}" for i in range(n_conv - 1)]
    return names


def params_from_jax(tree) -> dict:
    """Converts JAX ``BMSHJ2018Model`` params (the flax dict, as numpy or
    jax arrays, with or without the top-level "params" key) to this
    model's state_dict."""
    tree = tree.get("params", tree)
    state = {}
    for part, n_conv, gdn in _TRANSFORMS:
        for name in _layer_names(n_conv, gdn):
            for key, value in tree[part][name].items():
                state[f"{part}.{name}.{key}"] = torch.tensor(
                    np.asarray(value, np.float32))
    for key in ("matrices", "biases", "factors"):
        for i, value in enumerate(tree["hyperprior"][key]):
            state[f"hyperprior_{key}.{i}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state


def params_from_tf(tf_vars) -> dict:
    """Converts the reference's TF variables to this model's state_dict
    (counterpart of tools/port_tf_weights.port_bmshj2018 followed by
    params_from_jax).

    Args:
      tf_vars: mapping of TF names ("analysis/layer_0/rdft_real", ...,
        "hyper_synthesis/layer_0/kernel", ..., "prior/factor_1") to
        arrays, or of the same names as stored in
        tests/golden/golden_bmshj.npz ("var__analysis__layer_0__rdft_real",
        ...); other keys are ignored.  A SignalConv kernel is an RDFT
        real/imag pair or, in the hyper synthesis, a plain HWIO ``kernel``;
        GDN beta/gamma are their reparameterized variables: the forms this
        model stores.
    """
    names = {}
    for key, value in tf_vars.items():
        if key.startswith("var__"):
            key = key[len("var__"):].replace("__", "/")
        names[key] = np.asarray(value, np.float32)
    state = {}
    for side, n_conv, gdn in _TRANSFORMS:
        for i in range(n_conv):
            key = f"{side}/layer_{i}"
            if f"{key}/rdft_real" in names:
                state[f"{side}.layer_{i}.kernel_rdft"] = torch.tensor(
                    np.stack([names[f"{key}/rdft_real"],
                              names[f"{key}/rdft_imag"]]))
            else:
                state[f"{side}.layer_{i}.kernel"] = torch.tensor(
                    names[f"{key}/kernel"])
            if f"{key}/bias" in names:
                state[f"{side}.layer_{i}.bias"] = torch.tensor(
                    names[f"{key}/bias"])
        for i in range(n_conv - 1 if gdn else 0):
            key = f"{side}/{gdn}_{i}"
            state[f"{side}.{gdn}_{i}.reparam_beta"] = torch.tensor(
                names[f"{key}/beta"])
            state[f"{side}.{gdn}_{i}.reparam_gamma"] = torch.tensor(
                names[f"{key}/gamma"])
    num_layers = len([k for k in names if k.startswith("prior/matrix_")])
    for i in range(num_layers):
        state[f"hyperprior_matrices.{i}"] = torch.tensor(
            names[f"prior/matrix_{i}"])
        state[f"hyperprior_biases.{i}"] = torch.tensor(
            names[f"prior/bias_{i}"])
        if i < num_layers - 1:
            state[f"hyperprior_factors.{i}"] = torch.tensor(
                names[f"prior/factor_{i}"])
    return state


class BMSHJ2018Codec(ImageCodec):
    """Inference codec with frozen tables for both entropy models:
    ``ImageCodec``'s entry points over y and z, the classic container's 5
    tensors and the native one's 9.

    Args:
      model: a BMSHJ2018Model (moved to ``device``).
      device: where the codec runs; "cuda" unless the caller asks for the
        CPU.  On CUDA the range coder runs the hand-written kernels.
      tables: optional carried entropy-model weights, a pair
        ``([cdf_y, cdf_offset_y], [cdf_z, cdf_offset_z] or [cdf_z,
        cdf_offset_z, quantization_offset_z])`` (the JAX entropy models'
        ``get_weights()``); by default both tables are built on the CPU,
        the y table from the scale function and the z table from the
        model's hyperprior.

    The codec asks the model for ``encode``, ``hyper_decode``, ``decode``,
    ``hyperprior``, ``scale_fn``, ``num_scales`` and ``latent_depth``;
    ``_y_params`` turns the decoded hyper-latent into the y model's scale
    indexes and location (None here: bmshj2018 codes y about zero), which
    every entry point hands to the y entropy model, so that a model with a
    mean branch (HiFiC) runs the same code.
    """

    MODEL_ID = "bmshj2018"
    num_classic_tensors, num_native_tensors = 5, 9
    _y_em = property(lambda self: self.em)

    def __init__(self, model: BMSHJ2018Model, device="cuda", tables=None):
        super().__init__(model, device)
        y_tables, z_tables = tables if tables is not None else (None, None)
        cdf_y, cdf_offset_y = y_tables if y_tables is not None \
            else (None, None)
        self.em = LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, model.num_scales, model.scale_fn(),
            coding_rank=3, compression=True, cdf=cdf_y,
            cdf_offset=cdf_offset_y, device=self.device)
        if z_tables is None:
            self.side_em = ContinuousBatchedEntropyModel(
                prior=model.hyperprior(device="cpu"), coding_rank=3,
                compression=True, device=self.device)
        else:
            cdf, cdf_offset, *offset = z_tables
            self.side_em = ContinuousBatchedEntropyModel(
                prior_shape=tuple(model.hyperprior().batch_shape), cdf=cdf,
                cdf_offset=cdf_offset,
                quantization_offset=offset[0] if offset else None,
                coding_rank=3, compression=True, device=self.device)
        self.latent_depth = model.latent_depth

    def _encode(self, x):
        """Image -> (y, z, y's scale indexes and location, cropped to y)."""
        with profiling.span("transforms", "analysis", "dispatch"):
            y, z = self.model.encode(x.to(torch.float32)[None])
        return (y, z) + self._y_params(self.side_em.quantize(z),
                                       y.shape[1:3])

    def _y_params(self, z_hat, y_hw):
        """(scale indexes, location) of y from the quantized hyper-latent,
        cropped to y's extent; bmshj2018's location is None."""
        with profiling.span("transforms", "hyper_synthesis", "dispatch"):
            indexes = self.model.hyper_decode(z_hat)
        return indexes[:, : y_hw[0], : y_hw[1], :], None

    def _classic_fields(self, x):
        """y and z each in one reference-format stream."""
        y, z, indexes, loc = self._encode(x)
        with profiling.span("entropy", "encode.z"):
            side_strings = self.side_em.compress_to_strings(z)
        with profiling.span("entropy", "encode.y"):
            strings = self.em.compress_to_strings(y, indexes, loc=loc)
        return [strings, side_strings,
                np.asarray(tuple(x.shape[:2]), np.int32),
                np.asarray(tuple(y.shape[1:-1]), np.int32),
                np.asarray(tuple(z.shape[1:-1]), np.int32)]

    def _encode_native(self, x):
        y, z, indexes, loc = self._encode(x)
        with profiling.span("entropy", "encode.y"):
            y_out = self.em.compress_sidecar_device(
                native_format.to_streams(y),
                native_format.to_streams(indexes),
                loc=None if loc is None else native_format.to_streams(loc))
        with profiling.span("entropy", "encode.z"):
            z_out = self.side_em.compress_sidecar_device(
                native_format.to_streams(z))
        return (y_out, tuple(int(s) for s in y.shape[1:]),
                z_out, tuple(int(s) for s in z.shape[1:]),
                tuple(x.shape[:2]))

    def _native_fields(self, encoded):
        y_out, y_hwc, z_out, z_hwc, x_hw = encoded
        y_strings, y_pairs, y_vals = self._fetch(y_out, *y_hwc[1:])
        z_strings, z_pairs, z_vals = self._fetch(z_out, *z_hwc[1:])
        return [y_strings, z_strings, np.asarray(x_hw, np.int32),
                np.asarray(y_hwc[:2], np.int32),
                np.asarray(z_hwc[:2], np.int32),
                y_pairs.ravel(), y_vals, z_pairs.ravel(), z_vals]

    def _decode_native(self, packed):
        with profiling.span("container", "parse"):
            (strings, side_strings, x_shape, y_shape, z_shape, y_ep, y_ev,
             z_ep, z_ev) = packed.unpack(
                ["bytes", "bytes", np.int32, np.int32, np.int32,
                 np.int32, np.int32, np.int32, np.int32])
            hy, wy = int(y_shape[0]), int(y_shape[1])
            hz, wz = int(z_shape[0]), int(z_shape[1])
            cz = int(np.prod(self.side_em.prior_shape))
            cy = self.latent_depth
            k_z, z_buf, z_len, z_ei, z_evd = self._native_streams(
                side_strings, hz, wz, cz, z_ep, z_ev)
            k_y, y_buf, y_len, y_ei, y_evd = self._native_streams(
                strings, hy, wy, cy, y_ep, y_ev)
        with profiling.span("entropy", "decode.z"):
            z_rows, z_san = self.side_em.decompress_sidecar_device(
                z_buf, z_len, (1, wz // k_z), z_ei, z_evd)
        indexes, loc = self._y_params(
            native_format.from_streams(z_rows, hz, wz, cz), (hy, wy))
        if tuple(indexes.shape[1:3]) != (hy, wy):
            raise ValueError("latent shapes of the container disagree")
        rows = (hy * k_y, 1, wy // k_y, cy)
        with profiling.span("entropy", "decode.y"):
            y_rows, y_san = self.em.decompress_sidecar_device(
                y_buf, y_len, indexes[0].reshape(rows), y_ei, y_evd,
                loc=None if loc is None else loc[0].reshape(rows))
        return (native_format.from_streams(y_rows, hy, wy, cy),
                torch.cat([z_san, y_san]),
                (int(x_shape[0]), int(x_shape[1])))

    def _decode_classic(self, packed):
        with profiling.span("container", "parse"):
            strings, side_strings, x_shape, y_shape, z_shape = packed.unpack(
                ["bytes", "bytes", np.int32, np.int32, np.int32])
            for strs, shape in ((strings, y_shape), (side_strings, z_shape)):
                if len(strs) != 1 or shape.shape != (2,) or (shape < 1).any():
                    raise ValueError(
                        f"not a {self.MODEL_ID} classic container")
        side = self._classic_streams(side_strings)
        with profiling.span("entropy", "decode.z"):
            z_hat, z_san = self.side_em.decompress_device(
                *side, tuple(int(s) for s in z_shape))
        hy, wy = int(y_shape[0]), int(y_shape[1])
        indexes, loc = self._y_params(z_hat, (hy, wy))
        if tuple(indexes.shape[1:3]) != (hy, wy):
            raise ValueError("latent shapes of the container disagree")
        main = self._classic_streams(strings)
        with profiling.span("entropy", "decode.y"):
            y_hat, y_san = self.em.decompress_device(*main, indexes, loc=loc)
        return (y_hat, torch.cat([z_san, y_san]),
                (int(x_shape[0]), int(x_shape[1])))

    def _quantized_latent(self, x):
        """y rounded: the location-scale model rounds y whatever its
        indexes, so the hyper branch drops out."""
        y, _ = self.model.encode(x.to(torch.float32)[None])
        return self.em.quantize(y)


# The command line's hyperparameters and their defaults, the JAX package's.
CLI_DEFAULTS = dict(
    lmbda=0.01, num_filters=128, num_scales=64,
    scale_min=0.11, scale_max=256.0)


def model_from_config(config, seed=0) -> BMSHJ2018Model:
    """The model a checkpoint's config describes (CLI_DEFAULTS for what it
    lacks), with weights from ``seed``."""
    kwargs = {k: config.get(k, v) for k, v in CLI_DEFAULTS.items()}
    return BMSHJ2018Model(**kwargs, seed=seed)


def main(argv=None):
    """bmshj2018's command line (train / compress / decompress) at the JAX
    package's defaults (128 filters, 64 scales); runs on the card unless
    ``--device cpu`` is given."""
    from compression_tpu_torch.models import cli

    cli.run("bmshj2018", CLI_DEFAULTS, model_from_config, BMSHJ2018Codec,
            argv)


if __name__ == "__main__":
    main()
