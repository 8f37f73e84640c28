"""Channel-wise autoregressive image codec (Minnen & Singh 2020): its
training and serving paths (PyTorch counterpart of
compression_tpu/models/ms2020.py).

The latent ``y`` splits into ``num_slices`` channel slices.  Each slice's
mean and scale index come from the two hyper-synthesis outputs (z's mean
and scale branches) and the slices decoded before it (at most
``max_support_slices`` of them, the first ones), and a latent-residual
prediction ``0.5 * tanh(lrp)`` corrects each decoded slice.  The slice
loop is the model's one autoregression: mu and sigma stay on the device
throughout, and only a decode's range coder call of a slice waits for them.

``MS2020Codec`` (on ``image_codec.ImageCodec``) writes and reads two
containers: the reference's classic .tfci one (``compress``: one
reference-format stream for z and one per slice, escapes in-stream;
4 + num_slices tensors; on the card each is one stream, coded by one warp
of the in-stream-gamma kernels) and the native one (``compress_native``,
``compress_native_many``: row streams plus an escape sidecar for z and for
every slice; 6 + 3 * num_slices tensors).  Both compresses code the streams
of all slices in one launch after the slice loop (the encoder has no decode
dependency between slices, and a stream's bytes do not depend on the
grouping); both decompresses decode z, then one slice a launch inside the
slice loop.
``decompress`` and ``decompress_native_many`` read both containers,
``reconstruct`` skips the coder.  ``MS2020Model.forward(training=True)`` and
``make_train_step`` train the model (uniform noise on z and on each slice,
Adam); the codec and training run the same slice loop
(``MS2020Model.slice_loop``).  Weights come from a seeded init, from the JAX
package (``params_from_jax``) or from the reference's TF variables
(``params_from_tf``).  Images are uint8 [H, W, 3] (numpy or torch) and
latents [1, H, W, C], the JAX package's NHWC layout.

Spans (``util/profiling.py``, recorded only under a profiler): the shell's
(``models/image_codec.py``: the entries, ``codec.upload`` / ``.finish``,
``transforms.synthesis``, ``container.pack`` / ``.parse``),
``transforms.analysis`` / ``.hyper_synthesis``, ``entropy.encode.z`` /
``.decode.z``, ``entropy.encode.y`` around a compress's one y encode after
the loop, and ``entropy.decode.y`` around each slice's decode.  The slice
loop has a layer of its own: ``slices.loop`` around the whole of
``MS2020Model.slice_loop``, ``slices.params`` and ``slices.lrp`` a slice
inside it, so that every entry point and training share them.
``SLICE_CODER_CALLS`` counts the coder calls made inside the slice loop: 10
a classic or native decompress at 10 slices, none a compress or a
``reconstruct``.

"Channel-wise Autoregressive Entropy Models for Learned Image Compression"
https://arxiv.org/abs/2007.08739
"""

from __future__ import annotations

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
from compression_tpu_torch.models.bls2017 import make_train_step
from compression_tpu_torch.models.bmshj2018 import make_scale_fn
from compression_tpu_torch.models.image_codec import ImageCodec
from compression_tpu_torch.util import profiling

__all__ = [
    "AnalysisTransform",
    "SynthesisTransform",
    "HyperAnalysisTransform",
    "HyperSynthesisTransform",
    "SliceTransform",
    "MS2020Model",
    "MS2020Codec",
    "make_train_step",
    "params_from_jax",
    "params_from_tf",
    "CLI_DEFAULTS",
    "model_from_config",
    "main",
]

#: Range coder calls made inside the slice loop (one a slice of a classic
#: or native decompress; a compress codes after the loop) since the count
#: was last reset.
SLICE_CODER_CALLS = 0


def _count_slice_coder_call():
    global SLICE_CODER_CALLS
    SLICE_CODER_CALLS += 1


class AnalysisTransform(nn.Module):
    """x/255 -> three (conv5x5 s2, GDN) -> conv5x5 s2 to latent_depth
    (NHWC)."""

    def __init__(self, num_filters=192, latent_depth=320, generator=None):
        super().__init__()
        nf = num_filters
        for i in range(4):
            setattr(self, f"layer_{i}", SignalConv2D(
                3 if i == 0 else nf, latent_depth if i == 3 else nf, 5,
                corr=True, strides_down=2, padding="same_zeros", use_bias=True,
                generator=generator))
            if i < 3:
                setattr(self, f"gdn_{i}", GDN(nf))

    def forward(self, x):
        x = (x / 255.0).permute(0, 3, 1, 2)
        for i in range(3):
            x = getattr(self, f"gdn_{i}")(getattr(self, f"layer_{i}")(x))
        return self.layer_3(x).permute(0, 2, 3, 1)


class SynthesisTransform(nn.Module):
    """latent_depth -> three (conv5x5 up 2, IGDN) -> conv5x5 up 2 to three
    channels, scaled to [0, 255] (NHWC)."""

    def __init__(self, num_filters=192, latent_depth=320, generator=None):
        super().__init__()
        nf = num_filters
        for i in range(4):
            setattr(self, f"layer_{i}", SignalConv2D(
                latent_depth if i == 0 else nf, 3 if i == 3 else nf, 5,
                corr=False, strides_up=2, padding="same_zeros", use_bias=True,
                generator=generator))
            if i < 3:
                setattr(self, f"igdn_{i}", GDN(nf, inverse=True))

    def forward(self, y):
        y = y.permute(0, 3, 1, 2)
        for i in range(3):
            y = getattr(self, f"igdn_{i}")(getattr(self, f"layer_{i}")(y))
        return (self.layer_3(y) * 255.0).permute(0, 2, 3, 1)


class HyperAnalysisTransform(nn.Module):
    """conv3x3 s1, relu, conv5x5 s2, relu, conv5x5 s2 without bias, RDFT
    kernels (NHWC)."""

    def __init__(self, latent_depth=320, hyperprior_depth=192,
                 widths=(320, 256), generator=None):
        super().__init__()
        self.layer_0 = SignalConv2D(latent_depth, widths[0], 3, corr=True,
                                    strides_down=1,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.layer_1 = SignalConv2D(widths[0], widths[1], 5, corr=True,
                                    strides_down=2,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.layer_2 = SignalConv2D(widths[1], hyperprior_depth, 5,
                                    corr=True, strides_down=2,
                                    padding="same_zeros", use_bias=False,
                                    generator=generator)

    def forward(self, y):
        y = y.permute(0, 3, 1, 2)
        y = F.relu(self.layer_0(y))
        y = F.relu(self.layer_1(y))
        return self.layer_2(y).permute(0, 2, 3, 1)


def _plain_stack(module, in_channels, widths, supports, ups, generator):
    """Three plain-kernel convolutions (``kernel_parameter="variable"``)
    named layer_0..2."""
    for i, (filters, support, up) in enumerate(zip(widths, supports, ups)):
        setattr(module, f"layer_{i}", SignalConv2D(
            in_channels if i == 0 else widths[i - 1], filters, support,
            corr=False, strides_up=up, padding="same_zeros", use_bias=True,
            kernel_parameter="variable", generator=generator))


class HyperSynthesisTransform(nn.Module):
    """Three (conv, relu) with plain kernels: 5x5 up 2, 5x5 up 2, 3x3
    (NHWC)."""

    def __init__(self, hyperprior_depth=192, widths=(192, 256, 320),
                 generator=None):
        super().__init__()
        _plain_stack(self, hyperprior_depth, widths, (5, 5, 3), (2, 2, 1),
                     generator)

    def forward(self, z):
        z = z.permute(0, 3, 1, 2)
        for i in range(3):
            z = F.relu(getattr(self, f"layer_{i}")(z))
        return z.permute(0, 2, 3, 1)


class SliceTransform(nn.Module):
    """A slice's mean, scale or LRP predictor: conv5x5, relu, conv5x5,
    relu, conv3x3 to slice_depth, plain kernels, stride 1 (NHWC)."""

    def __init__(self, in_channels, slice_depth, widths=(224, 128),
                 generator=None):
        super().__init__()
        _plain_stack(self, in_channels, tuple(widths) + (slice_depth,),
                     (5, 5, 3), (1, 1, 1), generator)

    def forward(self, t):
        t = t.permute(0, 3, 1, 2)
        t = F.relu(self.layer_0(t))
        t = F.relu(self.layer_1(t))
        return self.layer_2(t).permute(0, 2, 3, 1)


class MS2020Model(nn.Module):
    """Rate-distortion model (training and eval forward), with the
    inference sub-graphs the codec runs (encode, hyper_decode,
    slice_params, lrp, slice_loop, decode); weights from a seeded init
    (``seed``) or carried over with ``params_from_jax`` /
    ``params_from_tf``."""

    def __init__(self, lmbda=0.01, num_filters=192, latent_depth=320,
                 hyperprior_depth=192, num_slices=10, max_support_slices=5,
                 num_scales=64, scale_min=0.11, scale_max=256.0,
                 ha_widths=(320, 256), hs_widths=(192, 256, 320),
                 slice_widths=(224, 128), seed=0):
        super().__init__()
        if latent_depth % num_slices:
            raise ValueError("Slices must evenly divide latent depth.")
        self.lmbda = float(lmbda)
        self.num_filters = int(num_filters)
        self.latent_depth = int(latent_depth)
        self.hyperprior_depth = int(hyperprior_depth)
        self.num_slices = int(num_slices)
        self.max_support_slices = int(max_support_slices)
        self.num_scales = int(num_scales)
        self.scale_min = float(scale_min)
        self.scale_max = float(scale_max)
        self.slice_depth = self.latent_depth // self.num_slices
        gen = torch.Generator().manual_seed(int(seed))
        self.analysis = AnalysisTransform(num_filters, latent_depth,
                                          generator=gen)
        self.synthesis = SynthesisTransform(num_filters, latent_depth,
                                            generator=gen)
        self.hyper_analysis = HyperAnalysisTransform(
            latent_depth, hyperprior_depth, tuple(ha_widths), generator=gen)
        self.hyper_synthesis_mean = HyperSynthesisTransform(
            hyperprior_depth, tuple(hs_widths), generator=gen)
        self.hyper_synthesis_scale = HyperSynthesisTransform(
            hyperprior_depth, tuple(hs_widths), generator=gen)
        sd = self.slice_depth
        for i in range(self.num_slices):
            support = hs_widths[-1] + sd * self._num_support(i)
            for group, extra in (("cc_mean", 0), ("cc_scale", 0),
                                 ("lrp", sd)):
                setattr(self, f"{group}_{i}", SliceTransform(
                    support + extra, sd, tuple(slice_widths),
                    generator=gen))
        prior = deep_factorized.DeepFactorized.init_params(
            (hyperprior_depth,), generator=gen)
        self.hyperprior_matrices = nn.ParameterList(prior["matrices"])
        self.hyperprior_biases = nn.ParameterList(prior["biases"])
        self.hyperprior_factors = nn.ParameterList(prior["factors"])

    def _num_support(self, i):
        if self.max_support_slices < 0:
            return i
        return min(i, self.max_support_slices)

    def support(self, y_hat_slices):
        """The decoded slices a slice is conditioned on: the first
        ``max_support_slices`` (all when negative)."""
        return list(y_hat_slices[: self._num_support(len(y_hat_slices))])

    def scale_fn(self):
        return make_scale_fn(self.scale_min, self.scale_max, self.num_scales)

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
            batch_shape=(self.hyperprior_depth,))

    def forward(self, x, training=False, generator=None, u=None):
        """Returns (loss, bpp, mse) for a uint8/float NHWC batch, the JAX
        package's ``__call__``: z's bits and each slice's, the slice loop
        with ``em_y.quantize`` as each slice's decoded value, the
        synthesis.

        In training mode z and every slice are perturbed with U(-.5, .5)
        noise: from ``generator`` (a ``torch.Generator`` on ``x``'s device,
        which draws z's noise first, then slice 0's, 1's, ...) or given as
        ``u = (u_z, u_0, ..., u_{num_slices-1})`` (the latents' shapes; the
        JAX package splits its key into num_slices + 1 keys in that order).
        In eval mode the latents are rounded.
        """
        x = torch.as_tensor(x).to(torch.float32)
        u_z, *u_y = (None,) * (1 + self.num_slices) if u is None else u
        em_z = ContinuousBatchedEntropyModel(
            prior=self.hyperprior(), coding_rank=3, compression=False,
            offset_heuristic=False, device=x.device)
        em_y = LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, self.num_scales, self.scale_fn(),
            coding_rank=3, compression=False, device=x.device)
        y, z = self.encode(x)
        num_pixels = int(x.shape[1] * x.shape[2])
        _, z_bits = em_z(z, training=training, generator=generator, u=u_z)
        z_bpp = torch.mean(z_bits) / num_pixels
        y_slices = torch.split(y, self.slice_depth, dim=-1)
        y_bpps = []

        def code(i, mu, sigma):
            _, bits = em_y(y_slices[i], sigma, loc=mu, training=training,
                           generator=generator, u=u_y[i])
            y_bpps.append(torch.mean(bits) / num_pixels)
            return em_y.quantize(y_slices[i], mu)

        y_hat = self.slice_loop(em_z.quantize(z),
                                tuple(int(s) for s in y.shape[1:3]), code)
        x_hat = self.decode(y_hat)[:, : x.shape[1], : x.shape[2], :]
        bpp = sum(y_bpps) + z_bpp
        mse = torch.mean(torch.square(x - x_hat))
        return bpp + self.lmbda * mse, bpp, mse

    # Inference sub-graphs (the JAX package's methods of the same names).
    def encode(self, x):
        y = self.analysis(x)
        return y, self.hyper_analysis(y)

    def hyper_decode(self, z_hat):
        """(latent_scales, latent_means) of a quantized hyper-latent."""
        return self.hyper_synthesis_scale(z_hat), \
            self.hyper_synthesis_mean(z_hat)

    @staticmethod
    def _slice_params(transform, latent, support_slices, y_hw):
        # The hyper-synthesis output is cropped to the latent's extent
        # before the concatenation (the JAX package's order), so inputs
        # that are no multiple of 64 work.
        latent = latent[:, : y_hw[0], : y_hw[1], :]
        support = torch.cat([latent] + list(support_slices), dim=-1)
        out = transform(support)
        return out[:, : y_hw[0], : y_hw[1], :], support

    def slice_params(self, i, latent_means, latent_scales, support_slices,
                     y_hw):
        """(mu, sigma, mean_support) of slice ``i``."""
        mu, mean_support = self._slice_params(
            getattr(self, f"cc_mean_{i}"), latent_means, support_slices, y_hw)
        sigma, _ = self._slice_params(
            getattr(self, f"cc_scale_{i}"), latent_scales, support_slices,
            y_hw)
        return mu, sigma, mean_support

    def lrp(self, i, mean_support, y_hat_slice):
        """The latent residual prediction of slice ``i``:
        0.5 * tanh(lrp_i([mean_support, y_hat_slice]))."""
        support = torch.cat([mean_support, y_hat_slice], dim=-1)
        return 0.5 * torch.tanh(getattr(self, f"lrp_{i}")(support))

    def slice_loop(self, z_hat, y_hw, code_slice):
        """The slice loop that training and every codec entry point run:
        slice i's (mu, sigma) from the hyper-synthesis outputs and the
        supporting decoded slices, ``code_slice(i, mu, sigma)`` -> the
        quantized slice, plus its LRP.  Returns y_hat [N, h, w,
        latent_depth]."""
        with profiling.span("slices", "loop"):
            with profiling.span("transforms", "hyper_synthesis", "dispatch"):
                latent_scales, latent_means = self.hyper_decode(z_hat)
            if (latent_means.shape[1] < y_hw[0]
                    or latent_means.shape[2] < y_hw[1]):
                raise ValueError("latent shapes of the container disagree")
            y_hat_slices = []
            for i in range(self.num_slices):
                with profiling.span("slices", "params", "dispatch"):
                    mu, sigma, mean_support = self.slice_params(
                        i, latent_means, latent_scales,
                        self.support(y_hat_slices), y_hw)
                y_hat_slice = code_slice(i, mu, sigma)
                with profiling.span("slices", "lrp", "dispatch"):
                    y_hat_slices.append(y_hat_slice + self.lrp(
                        i, mean_support, y_hat_slice))
            return torch.cat(y_hat_slices, dim=-1)

    def decode(self, y_hat):
        return self.synthesis(y_hat)


def _hyperprior_state(matrices, biases, factors):
    state = {}
    for key, values in (("matrices", matrices), ("biases", biases),
                        ("factors", factors)):
        for i, value in enumerate(values):
            state[f"hyperprior_{key}.{i}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state


def params_from_jax(tree) -> dict:
    """Converts JAX ``MS2020Model`` params (the flax dict, as numpy or jax
    arrays, with or without the top-level "params" key) to this model's
    state_dict: each transform's nested names joined with dots, the
    hyperprior's lists as ``hyperprior_{matrices,biases,factors}.i``."""
    tree = tree.get("params", tree)
    state = {}

    def walk(prefix, node):
        for key, value in node.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(f"{prefix}{key}.", value)
            else:
                state[prefix + key] = torch.tensor(
                    np.asarray(value, np.float32))

    for part, sub in tree.items():
        if part != "hyperprior":
            walk(f"{part}.", sub)
    prior = tree["hyperprior"]
    state.update(_hyperprior_state(prior["matrices"], prior["biases"],
                                   prior["factors"]))
    return state


# TF variable leaf -> this model's parameter name.
_TF_LEAVES = {"bias": "bias", "kernel": "kernel", "beta": "reparam_beta",
              "gamma": "reparam_gamma"}


def params_from_tf(tf_vars) -> dict:
    """Converts the reference's TF variables to this model's state_dict
    (counterpart of tools/port_tf_weights.port_ms2020 followed by
    params_from_jax).

    Args:
      tf_vars: mapping of TF names ("analysis/layer_0/rdft_real",
        "analysis/gdn_0/beta", "cc_mean_3/layer_1/kernel", ...,
        "prior/matrix_0", ...) to arrays, or of the same names as stored
        in tests/golden/golden_ms2020.npz ("var__analysis__layer_0__
        rdft_real", ...); other keys are ignored.  A SignalConv kernel is
        an RDFT real/imag pair (analysis, synthesis, hyper analysis) or a
        plain HWIO ``kernel`` (hyper syntheses, slice transforms); GDN
        beta/gamma are their reparameterized variables: the forms this
        model stores.
    """
    names = {}
    for key, value in tf_vars.items():
        if key.startswith("var__"):
            key = key[len("var__"):].replace("__", "/")
        names[key] = np.asarray(value, np.float32)
    state = {}
    for key, value in names.items():
        parts = key.split("/")
        if len(parts) != 3 or parts[0] == "prior":
            continue
        part, layer, leaf = parts
        if leaf == "rdft_real":
            state[f"{part}.{layer}.kernel_rdft"] = torch.tensor(np.stack(
                [value, names[f"{part}/{layer}/rdft_imag"]]))
        elif leaf in _TF_LEAVES:
            state[f"{part}.{layer}.{_TF_LEAVES[leaf]}"] = torch.tensor(value)
    num_layers = len([k for k in names if k.startswith("prior/matrix_")])
    state.update(_hyperprior_state(
        [names[f"prior/matrix_{i}"] for i in range(num_layers)],
        [names[f"prior/bias_{i}"] for i in range(num_layers)],
        [names[f"prior/factor_{i}"] for i in range(num_layers - 1)]))
    return state


class MS2020Codec(ImageCodec):
    """Inference codec: ``ImageCodec``'s entry points over the sequential
    slice loop, with the transforms and the coder's inputs on the device.

    Args:
      model: an MS2020Model (moved to ``device``).
      device: where the codec runs; "cuda" unless the caller asks for the
        CPU.  On CUDA both containers run the hand-written kernels.
      tables: optional carried entropy-model weights, a pair
        ``([cdf_y, cdf_offset_y], [cdf_z, cdf_offset_z])`` (the JAX entropy
        models' ``get_weights()``); by default both tables are built on the
        CPU, the y table from the scale function and the z table from the
        model's hyperprior without the offset heuristic, as the reference
        builds it.

    compress, compress_native, decompress and reconstruct run one slice
    loop (``MS2020Model.slice_loop``) over the same transform calls.
    """

    MODEL_ID = "ms2020"
    _y_em = property(lambda self: self.em_y)

    def __init__(self, model: MS2020Model, device="cuda", tables=None):
        super().__init__(model, device)
        y_tables, z_tables = tables if tables is not None else (None, None)
        cdf_y, cdf_offset_y = y_tables if y_tables is not None \
            else (None, None)
        self.em_y = LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, model.num_scales, model.scale_fn(),
            coding_rank=3, compression=True, cdf=cdf_y,
            cdf_offset=cdf_offset_y, device=self.device)
        if z_tables is None:
            self.em_z = ContinuousBatchedEntropyModel(
                prior=model.hyperprior(device="cpu"), coding_rank=3,
                compression=True, offset_heuristic=False, device=self.device)
        else:
            cdf, cdf_offset, *offset = z_tables
            self.em_z = ContinuousBatchedEntropyModel(
                prior_shape=(model.hyperprior_depth,), cdf=cdf,
                cdf_offset=cdf_offset,
                quantization_offset=offset[0] if offset else None,
                coding_rank=3, compression=True, offset_heuristic=False,
                device=self.device)
        self.num_native_tensors = 6 + 3 * model.num_slices
        self.num_classic_tensors = 4 + model.num_slices

    def _encode(self, x):
        with profiling.span("transforms", "analysis", "dispatch"):
            return self.model.encode(x.to(torch.float32)[None])

    def _slices(self, y):
        return torch.split(y, self.model.slice_depth, dim=-1)

    def _compress_slices(self, y, z):
        """The slice loop of a compress, with no coder call inside it: each
        slice's (mu, sigma) is kept and its quantized values, which are what
        its decode gives, feed the slices after it.  The encoder has no
        decode dependency between slices, and a stream's bytes do not depend
        on how streams are grouped in a launch, so the caller codes all
        slices in one call after the loop.  Returns (y's slices, their mus,
        their sigmas)."""
        y_slices = self._slices(y)
        mus, sigmas = [], []

        def code(i, mu, sigma):
            mus.append(mu)
            sigmas.append(sigma)
            return self.em_y.quantize(y_slices[i], mu)

        self.model.slice_loop(self.em_z.quantize(z),
                              tuple(int(s) for s in y.shape[1:3]), code)
        return y_slices, mus, sigmas

    def _classic_fields(self, x):
        """z in one reference-format stream, then the slices stacked into one
        encode of num_slices streams (one launch, one route and one fetch),
        each slice's string its own field."""
        y, z = self._encode(x)
        with profiling.span("entropy", "encode.z"):
            z_strings = self.em_z.compress_to_strings(z)
        y_slices, mus, sigmas = self._compress_slices(y, z)
        with profiling.span("entropy", "encode.y"):
            y_strings = self.em_y.compress_to_strings(
                torch.cat(y_slices), torch.cat(sigmas), loc=torch.cat(mus))
        return [np.asarray(tuple(x.shape[:2]), np.int32),
                np.asarray(tuple(y.shape[1:3]), np.int32),
                np.asarray(tuple(z.shape[1:3]), np.int32),
                z_strings] + [[s] for s in y_strings]

    def _encode_native(self, x):
        """The transforms, the slice loop and both sidecar encodes: z's
        streams in one launch, the streams of all slices stacked in
        another."""
        y, z = self._encode(x)
        y_hw = tuple(int(s) for s in y.shape[1:3])
        with profiling.span("entropy", "encode.z"):
            z_out = self.em_z.compress_sidecar_device(
                native_format.to_streams(z))
        y_slices, mus, sigmas = self._compress_slices(y, z)

        def stacked(parts):
            return torch.cat([native_format.to_streams(t) for t in parts])

        with profiling.span("entropy", "encode.y"):
            y_out = self.em_y.compress_sidecar_device(
                stacked(y_slices), stacked(sigmas), loc=stacked(mus))
        return (y_out, y_hw + (self.model.slice_depth,), z_out,
                tuple(int(s) for s in z.shape[1:]), tuple(x.shape[:2]))

    def _native_fields(self, encoded):
        """The stacked slice streams split back per slice (stream s belongs
        to slice s // streams-per-slice)."""
        y_out, (hy, wy, cs), z_out, (hz, wz, cz), x_hw = encoded
        z_strings, z_pairs, z_vals = self._fetch(z_out, wz, cz)
        y_strings, y_pairs, y_vals = self._fetch(y_out, wy, cs)
        s_y = hy * native_format.split_factor(wy, cs)
        slice_fields = []
        for i in range(self.model.num_slices):
            lo, hi = i * s_y, (i + 1) * s_y
            mine = (y_pairs[:, 0] >= lo) & (y_pairs[:, 0] < hi)
            slice_fields += [y_strings[lo:hi],
                             (y_pairs[mine] - np.asarray([lo, 0], np.int32)
                              ).ravel(), y_vals[mine]]
        return [np.asarray(x_hw, np.int32), np.asarray((hy, wy), np.int32),
                np.asarray((hz, wz), np.int32),
                z_strings, z_pairs.ravel(), z_vals] + slice_fields

    @staticmethod
    def _shapes(x_shape, y_shape, z_shape):
        for shape in (x_shape, y_shape, z_shape):
            if shape.shape != (2,) or (shape < 1).any():
                raise ValueError("not an ms2020 container")
        return tuple((int(s[0]), int(s[1])) for s in (x_shape, y_shape,
                                                      z_shape))

    def _decode_classic(self, packed):
        with profiling.span("container", "parse"):
            fields = packed.unpack(
                [np.int32] * 3 + ["bytes"] * (1 + self.model.num_slices))
            x_hw, y_hw, z_hw = self._shapes(*fields[:3])
            if any(len(s) != 1 for s in fields[3:]):
                raise ValueError("not an ms2020 classic container")
        z_stream = self._classic_streams(fields[3])
        with profiling.span("entropy", "decode.z"):
            z_hat, z_san = self.em_z.decompress_device(*z_stream, z_hw)
        sanity = [z_san]

        def decode(i, mu, sigma):
            stream = self._classic_streams(fields[4 + i])
            with profiling.span("entropy", "decode.y"):
                _count_slice_coder_call()
                y_slice, san = self.em_y.decompress_device(
                    *stream, sigma, loc=mu)
            sanity.append(san)
            return y_slice

        y_hat = self.model.slice_loop(z_hat, y_hw, decode)
        return y_hat, torch.cat(sanity), x_hw

    def _decode_native(self, packed):
        """Every container field is parsed and uploaded before the first
        launch; the slices decode one launch each inside the loop."""
        ns = self.model.num_slices
        cz, cs = self.model.hyperprior_depth, self.model.slice_depth
        with profiling.span("container", "parse"):
            fields = packed.unpack(
                [np.int32] * 3 + ["bytes", np.int32, np.int32] * (1 + ns))
            x_hw, (hy, wy), (hz, wz) = self._shapes(*fields[:3])
            k_z, *z_args = self._native_streams(
                fields[3], hz, wz, cz, fields[4], fields[5])
            slice_args = [self._native_streams(
                fields[6 + 3 * i], hy, wy, cs, fields[7 + 3 * i],
                fields[8 + 3 * i]) for i in range(ns)]
        with profiling.span("entropy", "decode.z"):
            z_rows, z_san = self.em_z.decompress_sidecar_device(
                z_args[0], z_args[1], (1, wz // k_z), z_args[2], z_args[3])
        sanity = [z_san]

        def code(i, mu, sigma):
            k, buf, lens, esc_idx, esc_val = slice_args[i]
            rows = (hy * k, 1, wy // k, cs)
            with profiling.span("entropy", "decode.y"):
                _count_slice_coder_call()
                y_rows, san = self.em_y.decompress_sidecar_device(
                    buf, lens, sigma[0].reshape(rows), esc_idx, esc_val,
                    loc=mu[0].reshape(rows))
            sanity.append(san)
            return native_format.from_streams(y_rows, hy, wy, cs)

        y_hat = self.model.slice_loop(
            native_format.from_streams(z_rows, hz, wz, cz), (hy, wy), code)
        return y_hat, torch.cat(sanity), x_hw

    def _quantized_latent(self, x):
        """The quantized hyper-latent drives the slice loop with
        ``em_y.quantize`` in place of the coder."""
        y, z = self._encode(x)
        y_slices = self._slices(y)
        return self.model.slice_loop(
            self.em_z.quantize(z), tuple(int(s) for s in y.shape[1:3]),
            lambda i, mu, sigma: self.em_y.quantize(y_slices[i], mu))


# The command line's hyperparameters and their defaults, the JAX package's.
CLI_DEFAULTS = dict(
    lmbda=0.01, num_filters=192, latent_depth=320,
    hyperprior_depth=192, num_slices=10, max_support_slices=5,
    num_scales=64, scale_min=0.11, scale_max=256.0)


def model_from_config(config, seed=0) -> MS2020Model:
    """The model a checkpoint's config describes (CLI_DEFAULTS for what it
    lacks), with weights from ``seed``."""
    kwargs = {k: config.get(k, v) for k, v in CLI_DEFAULTS.items()}
    return MS2020Model(**kwargs, seed=seed)


def main(argv=None):
    """ms2020's command line (train / compress / decompress) at the JAX
    package's defaults (192 filters, latent 320, hyperprior 192, 10
    slices); runs on the card unless
    ``--device cpu`` is given."""
    from compression_tpu_torch.models import cli

    cli.run("ms2020", CLI_DEFAULTS, model_from_config, MS2020Codec, argv)


if __name__ == "__main__":
    main()
