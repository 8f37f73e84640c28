"""Factorized-prior image codec (Ballé, Laparra, Simoncelli 2017): its
training and serving paths (PyTorch counterpart of
compression_tpu/models/bls2017.py).

A 3-layer SignalConv2D analysis transform with GDN (downsampling 4,2,2), a
mirrored synthesis transform with IGDN, a NoisyDeepFactorized prior over the
latent channels and a ContinuousBatchedEntropyModel with coding_rank=3.
``BLS2017Codec`` (on ``image_codec.ImageCodec``) writes and reads two
containers: the classic .tfci one of the reference (``compress``: one stream
per image, escapes in-stream) and the native one (``compress_native``,
``compress_native_many``: one stream per latent row block plus the escape
sidecar); ``decompress`` and ``decompress_native_many`` read both, and
``reconstruct`` skips the coder.  ``BLS2017Model.forward(training=True)``,
``make_train_step`` and ``train`` train the model (uniform noise on the
latent, Adam).  Weights come from a seeded init, from the JAX package
(``params_from_jax``) or from the reference's TF variables
(``params_from_tf``).  Images are uint8 [H, W, 3] (numpy or torch) and
latents [1, H, W, C], the JAX package's NHWC layout.

"End-to-end Optimized Image Compression"
https://openreview.net/forum?id=rJxdQ3jeg
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.signal_conv import SignalConv2D
from compression_tpu_torch.models import native_format
from compression_tpu_torch.models.image_codec import ImageCodec
from compression_tpu_torch.util import profiling
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "AnalysisTransform",
    "SynthesisTransform",
    "BLS2017Model",
    "BLS2017Codec",
    "make_train_step",
    "train",
    "params_from_jax",
    "params_from_tf",
    "CLI_DEFAULTS",
    "model_from_config",
    "main",
]


class AnalysisTransform(nn.Module):
    """x/255 -> conv9x9 s4 GDN -> conv5x5 s2 GDN -> conv5x5 s2 (NHWC)."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        self.layer_0 = SignalConv2D(3, nf, 9, corr=True, strides_down=4,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.gdn_0 = GDN(nf)
        self.layer_1 = SignalConv2D(nf, nf, 5, corr=True, strides_down=2,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.gdn_1 = GDN(nf)
        self.layer_2 = SignalConv2D(nf, nf, 5, corr=True, strides_down=2,
                                    padding="same_zeros", use_bias=False,
                                    generator=generator)

    def forward(self, x):
        x = (x / 255.0).permute(0, 3, 1, 2)
        x = self.gdn_0(self.layer_0(x))
        x = self.gdn_1(self.layer_1(x))
        return self.layer_2(x).permute(0, 2, 3, 1)


class SynthesisTransform(nn.Module):
    """Mirrored upsampling transform with IGDN; output scaled to [0,255]."""

    def __init__(self, num_filters=128, generator=None):
        super().__init__()
        nf = num_filters
        self.layer_0 = SignalConv2D(nf, nf, 5, corr=False, strides_up=2,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.igdn_0 = GDN(nf, inverse=True)
        self.layer_1 = SignalConv2D(nf, nf, 5, corr=False, strides_up=2,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)
        self.igdn_1 = GDN(nf, inverse=True)
        self.layer_2 = SignalConv2D(nf, 3, 9, corr=False, strides_up=4,
                                    padding="same_zeros", use_bias=True,
                                    generator=generator)

    def forward(self, y):
        y = y.permute(0, 3, 1, 2)
        y = self.igdn_0(self.layer_0(y))
        y = self.igdn_1(self.layer_1(y))
        return (self.layer_2(y) * 255.0).permute(0, 2, 3, 1)


class BLS2017Model(nn.Module):
    """Rate-distortion model (training and eval forward); weights from a
    seeded init (``seed``) or carried from the JAX package with
    ``params_from_jax``."""

    def __init__(self, lmbda=0.01, num_filters=128, seed=0):
        super().__init__()
        self.lmbda = float(lmbda)
        self.num_filters = int(num_filters)
        gen = torch.Generator().manual_seed(int(seed))
        self.analysis = AnalysisTransform(num_filters, generator=gen)
        self.synthesis = SynthesisTransform(num_filters, generator=gen)
        prior = deep_factorized.DeepFactorized.init_params(
            (num_filters,), generator=gen)
        self.prior_matrices = nn.ParameterList(prior["matrices"])
        self.prior_biases = nn.ParameterList(prior["biases"])
        self.prior_factors = nn.ParameterList(prior["factors"])

    def prior_params(self, device=None):
        def get(plist):
            return [p if device is None else p.detach().to(device)
                    for p in plist]
        return {"matrices": get(self.prior_matrices),
                "biases": get(self.prior_biases),
                "factors": get(self.prior_factors)}

    def prior(self, device=None):
        """NoisyDeepFactorized prior over the parameters themselves (what
        training differentiates), or over detached copies on ``device``
        when it is given (the codec's tables)."""
        return deep_factorized.NoisyDeepFactorized(
            params=self.prior_params(device),
            batch_shape=(self.num_filters,))

    def forward(self, x, training=False, generator=None, u=None):
        """Returns (loss, bpp, mse) for a uint8/float NHWC batch.

        In training mode the latent is perturbed with U(-.5, .5) noise from
        ``generator`` (a ``torch.Generator`` on ``x``'s device) or given as
        ``u`` (the latent's shape), and every result is differentiable in
        the model's parameters; in eval mode the latent is rounded.
        """
        x = torch.as_tensor(x).to(torch.float32)
        em = ContinuousBatchedEntropyModel(
            prior=self.prior(), coding_rank=3, compression=False,
            offset_heuristic=False, device=x.device)
        y = self.analysis(x)
        y_hat, bits = em(y, training=training, generator=generator, u=u)
        x_hat = self.synthesis(y_hat)[:, : x.shape[1], : x.shape[2], :]
        num_pixels = int(np.prod(x.shape[:-1]))
        bpp = torch.sum(bits) / num_pixels
        mse = torch.mean(torch.square(x - x_hat))
        return bpp + self.lmbda * mse, bpp, mse

    def decode(self, y_hat):
        return self.synthesis(y_hat)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Returns ``step(batch, generator=None, u=None)``: one rate-distortion
    step of ``model`` (a BLS2017Model, BMSHJ2018Model or MS2020Model) on a
    uint8/float NHWC batch, which it moves to the model's device.
    ``generator`` or ``u`` is the training noise (``model.forward``).  The
    step returns {"loss", "bpp", "mse"} as 0-d tensors on the model's
    device, so that it never waits for the card.  With ``torch.optim.Adam``
    the update is optax.adam's (m_hat / (sqrt(v_hat) + eps)).
    """
    def step(batch, generator=None, u=None):
        with profiling.span("train", "step", request=True):
            optimizer.zero_grad(set_to_none=True)
            metrics = rd_backward(model, batch, generator=generator, u=u)
            with profiling.span("train", "optimizer", "dispatch"):
                optimizer.step()
            return metrics

    return step


def rd_backward(model: nn.Module, batch, generator=None, u=None) -> dict:
    """The forward and backward half of a rate-distortion step, shared by
    ``make_train_step`` and the data-parallel steps of
    ``parallel/sharding.py``, which reduce the gradients before the
    optimizer steps: moves the batch to the model's device, sets every
    parameter's gradient afresh and returns {"loss", "bpp", "mse"} as 0-d
    tensors on that device."""
    device = next(model.parameters()).device
    if isinstance(batch, torch.Tensor) and batch.device == device:
        batch = batch.to(torch.float32)
    else:
        with profiling.wait("upload"):
            batch = torch.as_tensor(batch, device=device).to(torch.float32)
    model.zero_grad(set_to_none=True)
    with profiling.span("train", "forward", "dispatch"):
        loss, bpp, mse = model(batch, training=True, generator=generator,
                               u=u)
    with profiling.span("train", "backward", "dispatch"):
        loss.backward()
    return {"loss": loss.detach(), "bpp": bpp.detach(), "mse": mse.detach()}


def train(lmbda=0.01, num_filters=128, batch_size=8, patchsize=256,
          steps=1000, learning_rate=1e-4, data_iter=None, seed=0,
          log_every=100, device="cuda"):
    """Trains a BLS2017Model with Adam; returns the model.

    ``data_iter`` yields uint8/float NHWC batches; if None, random noise
    patches from ``np.random.RandomState(seed)`` are used (the JAX
    package's batches; smoke training only, nothing is downloaded).  The
    weights come from ``seed`` and the noise from a generator on
    ``device`` seeded with it.  Runs on the card unless the caller passes
    device="cpu"; convolutions follow torch.backends' TF32 flags.
    """
    device = resolve_device(device)
    model = BLS2017Model(lmbda=lmbda, num_filters=num_filters,
                         seed=seed).to(device)
    step_fn = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=learning_rate))
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def default_iter():
        rng = np.random.RandomState(seed)
        while True:
            yield rng.randint(
                0, 256, (batch_size, patchsize, patchsize, 3)).astype(
                    np.float32)

    it = data_iter if data_iter is not None else default_iter()
    for step, batch in zip(range(steps), it):
        metrics = step_fn(batch, generator=generator)
        if log_every and step % log_every == 0:
            print({k: float(v) for k, v in metrics.items()}, flush=True)
    return model


def params_from_jax(tree) -> dict:
    """Converts JAX ``BLS2017Model`` params (the flax dict, as numpy or jax
    arrays, with or without the top-level "params" key) to this model's
    state_dict."""
    tree = tree.get("params", tree)
    state = {}
    for part, layers in (("analysis", ("layer_0", "gdn_0", "layer_1",
                                       "gdn_1", "layer_2")),
                         ("synthesis", ("layer_0", "igdn_0", "layer_1",
                                        "igdn_1", "layer_2"))):
        for name in layers:
            for key, value in tree[part][name].items():
                state[f"{part}.{name}.{key}"] = torch.tensor(
                    np.asarray(value, np.float32))
    for key in ("matrices", "biases", "factors"):
        for i, value in enumerate(tree["prior"][key]):
            state[f"prior_{key}.{i}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state


def params_from_tf(tf_vars) -> dict:
    """Converts the reference's TF variables to this model's state_dict
    (counterpart of tools/port_tf_weights.port_bls2017 followed by
    params_from_jax).

    Args:
      tf_vars: mapping of TF names ("analysis/layer_0/rdft_real", ...,
        "prior/factor_1") to arrays, or of the same names as stored in
        tests/golden/golden_model.npz ("var__analysis__layer_0__rdft_real",
        ...); other keys are ignored.  SignalConv kernels are RDFT
        real/imag pairs, GDN beta/gamma their reparameterized variables:
        the forms this model stores.
    """
    names = {}
    for key, value in tf_vars.items():
        if key.startswith("var__"):
            key = key[len("var__"):].replace("__", "/")
        names[key] = np.asarray(value, np.float32)
    state = {}
    for side, gdn in (("analysis", "gdn"), ("synthesis", "igdn")):
        for i in range(3):
            key = f"{side}/layer_{i}"
            state[f"{side}.layer_{i}.kernel_rdft"] = torch.tensor(np.stack(
                [names[f"{key}/rdft_real"], names[f"{key}/rdft_imag"]]))
            if f"{key}/bias" in names:
                state[f"{side}.layer_{i}.bias"] = torch.tensor(
                    names[f"{key}/bias"])
        for i in range(2):
            key = f"{side}/{gdn}_{i}"
            state[f"{side}.{gdn}_{i}.reparam_beta"] = torch.tensor(
                names[f"{key}/beta"])
            state[f"{side}.{gdn}_{i}.reparam_gamma"] = torch.tensor(
                names[f"{key}/gamma"])
    num_layers = len([k for k in names if k.startswith("prior/matrix_")])
    for i in range(num_layers):
        state[f"prior_matrices.{i}"] = torch.tensor(names[f"prior/matrix_{i}"])
        state[f"prior_biases.{i}"] = torch.tensor(names[f"prior/bias_{i}"])
        if i < num_layers - 1:
            state[f"prior_factors.{i}"] = torch.tensor(
                names[f"prior/factor_{i}"])
    return state


class BLS2017Codec(ImageCodec):
    """Inference codec with frozen range-coding tables: ``ImageCodec``'s
    entry points over one latent, the classic container's 3 tensors and the
    native one's 5.

    Args:
      model: a BLS2017Model (moved to ``device``).
      device: where the codec runs; "cuda" unless the caller asks for the
        CPU.  On CUDA the range coder runs the hand-written kernels.
      tables: optional carried entropy-model weights ``[cdf, cdf_offset]``
        or ``[cdf, cdf_offset, quantization_offset]`` (the JAX
        entropy model's ``get_weights()``); by default the tables are built
        from the model's prior on the CPU.
    """

    MODEL_ID = "bls2017"
    num_classic_tensors, num_native_tensors = 3, 5
    _y_em = property(lambda self: self.em)

    def __init__(self, model: BLS2017Model, device="cuda", tables=None):
        super().__init__(model, device)
        nf = model.num_filters
        if tables is None:
            self.em = ContinuousBatchedEntropyModel(
                prior=model.prior(device="cpu"), coding_rank=3,
                compression=True, device=self.device)
        else:
            cdf, cdf_offset, *offset = tables
            self.em = ContinuousBatchedEntropyModel(
                prior_shape=(nf,), cdf=cdf, cdf_offset=cdf_offset,
                quantization_offset=offset[0] if offset else None,
                coding_rank=3, compression=True, device=self.device)

    def _analysis(self, x):
        with profiling.span("transforms", "analysis", "dispatch"):
            return self.model.analysis(x.to(torch.float32)[None])

    def _classic_fields(self, x):
        """The whole latent in one reference-format stream."""
        y = self._analysis(x)
        with profiling.span("entropy", "encode.y"):
            strings = self.em.compress_to_strings(y)
        return [strings, np.asarray(tuple(x.shape[:2]), np.int32),
                np.asarray(tuple(y.shape[1:-1]), np.int32)]

    def _encode_native(self, x):
        y = self._analysis(x)
        with profiling.span("entropy", "encode.y"):
            y_out = self.em.compress_sidecar_device(
                native_format.to_streams(y))
        return y_out, tuple(int(s) for s in y.shape[1:]), tuple(x.shape[:2])

    def _native_fields(self, encoded):
        y_out, (h, w, c), x_hw = encoded
        strings, pairs, vals = self._fetch(y_out, w, c)
        return [strings, np.asarray(x_hw, np.int32),
                np.asarray((h, w), np.int32), pairs.ravel(), vals]

    def _decode_native(self, packed):
        with profiling.span("container", "parse"):
            strings, x_shape, y_shape, esc_pos, esc_val = packed.unpack(
                ["bytes", np.int32, np.int32, np.int32, np.int32])
            h, w = int(y_shape[0]), int(y_shape[1])
            c = int(np.prod(self.em.prior_shape))
            k, buf, lens, esc_idx, esc_val = self._native_streams(
                strings, h, w, c, esc_pos, esc_val)
        with profiling.span("entropy", "decode.y"):
            y_rows, sanity = self.em.decompress_sidecar_device(
                buf, lens, (1, w // k), esc_idx, esc_val)
        return (native_format.from_streams(y_rows, h, w, c), sanity,
                (int(x_shape[0]), int(x_shape[1])))

    def _decode_classic(self, packed):
        with profiling.span("container", "parse"):
            strings, x_shape, y_shape = packed.unpack(
                ["bytes", np.int32, np.int32])
            if (len(strings) != 1 or y_shape.shape != (2,)
                    or (y_shape < 1).any()):
                raise ValueError("not a bls2017 classic container")
        stream = self._classic_streams(strings)
        with profiling.span("entropy", "decode.y"):
            y_hat, sanity = self.em.decompress_device(*stream,
                                                      tuple(y_shape))
        return y_hat, sanity, (int(x_shape[0]), int(x_shape[1]))

    def _quantized_latent(self, x):
        return self.em.quantize(self._analysis(x))


# The command line's hyperparameters and their defaults, the JAX package's.
CLI_DEFAULTS = dict(lmbda=0.01, num_filters=128)


def model_from_config(config, seed=0) -> BLS2017Model:
    """The model a checkpoint's config describes (CLI_DEFAULTS for what it
    lacks), with weights from ``seed``."""
    kwargs = {k: config.get(k, v) for k, v in CLI_DEFAULTS.items()}
    return BLS2017Model(**kwargs, seed=seed)


def main(argv=None):
    """bls2017's command line (train / compress / decompress) at the JAX
    package's defaults (128 filters); runs on the card unless ``--device
    cpu`` is given."""
    from compression_tpu_torch.models import cli

    cli.run("bls2017", CLI_DEFAULTS, model_from_config, BLS2017Codec, argv)


if __name__ == "__main__":
    main()
