"""lvac: lossy variational audio compression (PyTorch counterpart of
compression_tpu/models/lvac.py; the reference ships it as the notebook
models/lvac/lvac.ipynb).

A 1-D SignalConv autoencoder over audio frames with a NoisyDeepFactorized
bottleneck, trained with the rate-distortion Lagrangian of the image codecs:
three SignalConv1D of support 9 (strides down 4, 2, 2) with GDN, mirrored by
three upsampling ones (2, 2, 4) with IGDN to one channel.  Frames are
[batch, samples, 1] (the JAX package's channels-last layout) and the latent
[batch, samples / 16, num_filters]; the layers run channels-first inside
the transforms.  Weights come from a seeded init or from the JAX package
(``params_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.signal_conv import SignalConv1D
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "AnalysisTransform",
    "SynthesisTransform",
    "LVACModel",
    "make_train_step",
    "train",
    "sine_batches",
    "params_from_jax",
]


class AnalysisTransform(nn.Module):
    """[B, T, 1] -> three (conv9 corr, strides 4, 2, 2), GDN after the first
    two -> [B, T / 16, num_filters]."""

    def __init__(self, num_filters=64, generator=None):
        super().__init__()
        for i, down in enumerate((4, 2, 2)):
            setattr(self, f"layer_{i}", SignalConv1D(
                1 if i == 0 else num_filters, num_filters, 9, corr=True,
                strides_down=down, padding="same_zeros", use_bias=True,
                generator=generator))
            if i < 2:
                setattr(self, f"gdn_{i}", GDN(num_filters))

    def forward(self, x):
        x = x.permute(0, 2, 1)
        for i in range(2):
            x = getattr(self, f"gdn_{i}")(getattr(self, f"layer_{i}")(x))
        return self.layer_2(x).permute(0, 2, 1)


class SynthesisTransform(nn.Module):
    """[B, T', num_filters] -> three (conv9, strides up 2, 2, 4), IGDN after
    the first two, the last to one channel -> [B, 16 T', 1]."""

    def __init__(self, num_filters=64, generator=None):
        super().__init__()
        for i, up in enumerate((2, 2, 4)):
            setattr(self, f"layer_{i}", SignalConv1D(
                num_filters, 1 if i == 2 else num_filters, 9, corr=False,
                strides_up=up, padding="same_zeros", use_bias=True,
                generator=generator))
            if i < 2:
                setattr(self, f"igdn_{i}", GDN(num_filters, inverse=True))

    def forward(self, y):
        y = y.permute(0, 2, 1)
        for i in range(2):
            y = getattr(self, f"igdn_{i}")(getattr(self, f"layer_{i}")(y))
        return self.layer_2(y).permute(0, 2, 1)


class LVACModel(nn.Module):
    """Rate-distortion model over [batch, samples, 1] audio frames."""

    def __init__(self, lmbda=100.0, num_filters=64, seed=0):
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

    def prior(self):
        return deep_factorized.NoisyDeepFactorized(
            params={"matrices": list(self.prior_matrices),
                    "biases": list(self.prior_biases),
                    "factors": list(self.prior_factors)},
            batch_shape=(self.num_filters,))

    def forward(self, x, training=True, generator=None, u=None):
        """Returns (loss, bps, mse) for a [batch, samples, 1] batch.

        In training mode the latent is perturbed with U(-.5, .5) noise from
        ``generator`` (a ``torch.Generator`` on ``x``'s device) or given as
        ``u`` (the latent's shape, [batch, samples / 16, num_filters]); in
        eval mode it is rounded.
        """
        x = torch.as_tensor(x).to(torch.float32)
        em = ContinuousBatchedEntropyModel(
            prior=self.prior(), coding_rank=2, compression=False,
            offset_heuristic=False, device=x.device)
        y = self.analysis(x)
        y_hat, bits = em(y, training=training, generator=generator, u=u)
        x_hat = self.synthesis(y_hat)[:, : x.shape[1], :]
        bps = torch.sum(bits) / (x.shape[0] * x.shape[1])
        mse = torch.mean(torch.square(x - x_hat))
        return bps + self.lmbda * mse, bps, mse


def make_train_step(model: LVACModel, optimizer: torch.optim.Optimizer):
    """Returns ``step(batch, generator=None, u=None)``: one rate-distortion
    step on a [batch, samples, 1] batch, moved to the model's device;
    returns {"loss", "bps", "mse"} as 0-d tensors on that device."""
    device = next(model.parameters()).device

    def step(batch, generator=None, u=None):
        batch = torch.as_tensor(batch, device=device).to(torch.float32)
        optimizer.zero_grad(set_to_none=True)
        loss, bps, mse = model(batch, training=True, generator=generator,
                               u=u)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "bps": bps.detach(),
                "mse": mse.detach()}

    return step


def sine_batches(batch_size=8, frame=1024, seed=0):
    """The JAX package's toy audio: each frame a sum of three sines (100 to
    2000 Hz at 16 kHz, amplitudes 0.1 to 0.5) from
    ``np.random.RandomState(seed)``; yields [batch, frame, 1] float32."""
    rng = np.random.RandomState(seed)
    t = np.arange(frame) / 16000.0
    while True:
        f = rng.uniform(100, 2000, (batch_size, 3, 1))
        a = rng.uniform(0.1, 0.5, (batch_size, 3, 1))
        wave = (a * np.sin(2 * np.pi * f * t[None, None, :])).sum(1)
        yield wave[..., None].astype(np.float32)


def train(steps=500, batch_size=8, frame=1024, lmbda=100.0, seed=0,
          data_iter=None, log_every=100, num_filters=64, learning_rate=1e-4,
          device="cuda"):
    """Trains an LVACModel with Adam on ``sine_batches`` unless an iterator
    is given; returns the model.  The weights come from ``seed`` and the
    noise from a generator on ``device`` seeded with it.  Runs on the card
    unless the caller passes device="cpu"."""
    device = resolve_device(device)
    model = LVACModel(lmbda=lmbda, num_filters=num_filters,
                      seed=seed).to(device)
    step_fn = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=learning_rate))
    generator = torch.Generator(device=device).manual_seed(int(seed))
    it = data_iter if data_iter is not None else sine_batches(
        batch_size, frame, seed)
    for i, batch in zip(range(steps), it):
        metrics = step_fn(batch, generator=generator)
        if log_every and i % log_every == 0:
            print({k: float(v) for k, v in metrics.items()}, flush=True)
    return model


def params_from_jax(tree) -> dict:
    """Converts JAX ``LVACModel`` params (the flax dict, with or without the
    top-level "params" key) to this model's state_dict."""
    tree = tree.get("params", tree)
    state = {}
    for part in ("analysis", "synthesis"):
        for name, leaves in tree[part].items():
            for key, value in leaves.items():
                state[f"{part}.{name}.{key}"] = torch.tensor(
                    np.asarray(value, np.float32))
    for key in ("matrices", "biases", "factors"):
        for i, value in enumerate(tree["prior"][key]):
            state[f"prior_{key}.{i}"] = torch.tensor(
                np.asarray(value, np.float32))
    return state
