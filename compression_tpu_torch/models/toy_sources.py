"""Toy-source research harness (PyTorch counterpart of
compression_tpu/models/toy_sources.py; reference models/toy_sources/*).

Stochastic process sources (ramp, sawbridge, sinusoid, sphere), the
nonlinear-transform-coding ``NTCModel`` with deep / GSM / GMM / LSM / LMM
priors and dither / soft-round options, the entropy-constrained vector
quantizer ``VECVQModel``, and their rate-distortion training loop.

Sources draw from a ``torch.Generator`` (on the device the samples should
lie on) or take fixed ``phase`` / ``drop`` values.  Models are
``nn.Module``s; the training noise comes from a generator or is passed as
``u``, which a test uses to share the JAX package's noise.  As in JAX,
every mixture prior gets a trainable ``loc``: JAX tests ``"m" in
prior_type[:4]``, which holds for "gsm-" and "lsm-" too.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.distributions import base as dist_base
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions import round_adapters
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "ramp_sample",
    "sawbridge_sample",
    "sinusoid_sample",
    "sphere_sample",
    "MLP",
    "NTCModel",
    "VECVQModel",
    "make_ntc_train_step",
    "train_ntc",
    "params_from_jax",
]

# std of a standard normal truncated to (-2, 2): flax's lecun_normal
# (variance_scaling(1, fan_in, truncated_normal)) divides by it.
_TRUNC_STD = 0.87962566103423978


# --- sources -----------------------------------------------------------------
def _points(index_points):
    ind = torch.as_tensor(index_points)
    return ind if ind.is_floating_point() else ind.to(torch.float32)


def _uniform(shape, like, generator):
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def ramp_sample(n, index_points, phase=None, generator=None):
    """Y(t) = (t + V) mod 1 - 0.5, V ~ U[0, 1) (reference ramp.py)."""
    ind = _points(index_points)
    phase = (_uniform((n, 1), ind, generator) if phase is None
             else torch.full((n, 1), phase, dtype=ind.dtype,
                             device=ind.device))
    return (ind + phase) % 1 - 0.5


def sawbridge_sample(n, index_points, phase=None, drop=None, stationary=True,
                     order=1, generator=None):
    """B(t) = t - 1(t > Z), stationarized and order-averaged."""
    ind = _points(index_points)
    z = (_uniform((order, n, 1), ind, generator) if drop is None
         else torch.full((order, n, 1), drop, dtype=ind.dtype,
                         device=ind.device))
    t = ind
    if stationary:
        v = (_uniform((n, 1), ind, generator) if phase is None
             else torch.as_tensor(phase, dtype=ind.dtype, device=ind.device))
        t = (ind + v) % 1
    out = t - (t > z).to(ind.dtype)
    return torch.mean(out, dim=0) * torch.sqrt(
        torch.tensor(float(order), dtype=ind.dtype, device=ind.device))


def sinusoid_sample(n, index_points, phase=None, generator=None):
    """X(t) = sin(2 pi (t + V))."""
    ind = _points(index_points)
    phase = (_uniform((n, 1), ind, generator) if phase is None
             else torch.full((n, 1), phase, dtype=ind.dtype,
                             device=ind.device))
    return torch.sin(2 * math.pi * (ind + phase))


def sphere_sample(n, order=2, width=0.0, generator=None, device=None):
    """Uniform on the unit sphere (optionally a thick shell).

    The samples lie on ``device``; by default on the generator's device, or
    on the card when no generator is given."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    device = resolve_device(device)
    samples = torch.randn((n, order), generator=generator, device=device)
    radius = torch.sqrt(torch.sum(torch.square(samples), -1, keepdim=True))
    if width:
        radius = radius * (1 - width / 2 + width * torch.rand(
            (n, 1), generator=generator, device=device))
    return samples / radius


# --- models ------------------------------------------------------------------
class Dense(nn.Module):
    """flax's Dense: ``x @ kernel + bias``, kernel [in, out] from
    lecun_normal (a normal truncated to two std, of variance 1 / in after
    the truncation), bias zero."""

    def __init__(self, in_features, out_features, generator=None):
        super().__init__()
        kernel = torch.empty((in_features, out_features))
        nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
        kernel *= (1.0 / in_features) ** 0.5 / _TRUNC_STD
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """Small MLP transform (the reference notebooks use 2 x 100 softplus):
    layers dense_0 .. dense_{k-1} with the activation, then out."""

    def __init__(self, in_features, features: Sequence[int],
                 activation: Callable = F.softplus, generator=None):
        super().__init__()
        self.activation = activation
        widths = (in_features,) + tuple(features)
        self.num_hidden = len(features) - 1
        for i in range(self.num_hidden):
            setattr(self, f"dense_{i}",
                    Dense(widths[i], widths[i + 1], generator))
        self.out = Dense(widths[-2], widths[-1], generator)

    def forward(self, x):
        for i in range(self.num_hidden):
            x = self.activation(getattr(self, f"dense_{i}")(x))
        return self.out(x)


def _noise(u, shape, like, generator):
    """The given noise, or U(-.5, .5) drawn from ``generator``."""
    if u is not None:
        return torch.as_tensor(u, dtype=like.dtype, device=like.device)
    noise = torch.empty(shape, dtype=like.dtype, device=like.device)
    return noise.uniform_(-0.5, 0.5, generator=generator)


class NTCModel(nn.Module):
    """Nonlinear transform coding on a toy source (reference ntc.py).

    ``prior_type`` is "deep" or "gsm-K" / "gmm-K" / "lsm-K" / "lmm-K" (a
    K-component Normal or Logistic mixture per latent dimension).
    ``dither`` is (rate, distortion) for training, then for testing: True
    adds uniform noise, False rounds; ``soft_round`` is (training,
    testing).  Weights from a seeded init, or ``params_from_jax``.
    """

    def __init__(self, ndim_source, ndim_latent, lmbda=1.0,
                 distortion_loss="sse", prior_type="deep",
                 dither=(True, True, False, False), soft_round=(True, False),
                 guess_offset=False, hidden=100, seed=0):
        super().__init__()
        self.ndim_source = int(ndim_source)
        self.ndim_latent = int(ndim_latent)
        self.lmbda = float(lmbda)
        self.distortion_loss = distortion_loss
        self.prior_type = prior_type
        self.dither = tuple(bool(d) for d in dither)
        self.soft_round = tuple(bool(s) for s in soft_round)
        self.guess_offset = bool(guess_offset)
        gen = torch.Generator().manual_seed(int(seed))
        self.analysis_mlp = MLP(ndim_source, (hidden, hidden, ndim_latent),
                                generator=gen)
        self.synthesis_mlp = MLP(ndim_latent, (hidden, hidden, ndim_source),
                                 generator=gen)
        if prior_type == "deep":
            prior = deep_factorized.DeepFactorized.init_params(
                (self.ndim_latent,), generator=gen)
            self.prior_matrices = nn.ParameterList(prior["matrices"])
            self.prior_biases = nn.ParameterList(prior["biases"])
            self.prior_factors = nn.ParameterList(prior["factors"])
        elif prior_type[:4] in ("gsm-", "gmm-", "lsm-", "lmm-"):
            shape = (self.ndim_latent, int(prior_type[4:]))
            self.logits = nn.Parameter(torch.randn(shape, generator=gen))
            self.log_scale = nn.Parameter(
                2.0 + torch.randn(shape, generator=gen))
            # JAX's test, "m" in prior_type[:4], is true for all four.
            self.loc = nn.Parameter(torch.randn(shape, generator=gen))
        else:
            raise ValueError(f"Unknown prior_type: '{prior_type}'.")
        self.logit_alpha = nn.Parameter(torch.tensor(-3.0))

    @property
    def alpha(self):
        return torch.sigmoid(self.logit_alpha) * 4.0

    def prior(self, soft_round, skip_noise=False):
        if self.prior_type == "deep":
            prior = deep_factorized.DeepFactorized(
                params={"matrices": list(self.prior_matrices),
                        "biases": list(self.prior_biases),
                        "factors": list(self.prior_factors)},
                batch_shape=(self.ndim_latent,))
        else:
            cls = (dist_base.Normal if self.prior_type.startswith("g")
                   else dist_base.Logistic)
            prior = dist_base.MixtureSameFamily(
                mixture_distribution=dist_base.Categorical(
                    logits=self.logits),
                components_distribution=cls(
                    loc=self.loc, scale=torch.exp(self.log_scale)))
        if soft_round:
            prior = round_adapters.SoftRoundAdapter(prior, self.alpha)
        if skip_noise:
            return prior
        return uniform_noise.UniformNoiseAdapter(prior)

    def analysis(self, x):
        y = self.analysis_mlp(x.reshape(-1, self.ndim_source))
        return y.reshape(x.shape[:-1] + (self.ndim_latent,))

    def synthesis(self, y):
        x = self.synthesis_mlp(y.reshape(-1, self.ndim_latent))
        return x.reshape(y.shape[:-1] + (self.ndim_source,))

    def distortion_fn(self, reference, reconstruction):
        diff = torch.square(reference - reconstruction)
        if self.distortion_loss == "sse":
            return torch.sum(diff, dim=-1)
        if self.distortion_loss == "mse":
            return torch.mean(diff, dim=-1)
        raise ValueError(self.distortion_loss)

    def encode_decode(self, x, dither_rate, dither_dist, soft_round,
                      generator=None, u=None, offset=0.0):
        """Returns (y_dist, x_hat, rates).  Dithered paths take their noise
        from ``u`` = (rate noise, distortion noise), the latent's shape
        each (JAX's ``jax.random.split(key)``: k1, k2), or from
        ``generator``."""
        prior = self.prior(soft_round=soft_round)
        u_rate, u_dist = (None, None) if u is None else u

        def perturb(inputs, dither, noise):
            if dither:
                if soft_round:
                    inputs = round_ops.soft_round(inputs, self.alpha)
                inputs = inputs + _noise(noise, inputs.shape, inputs,
                                         generator)
                if soft_round:
                    inputs = round_ops.soft_round_conditional_mean(
                        inputs, self.alpha)
                return inputs
            off = None if isinstance(offset, float) and offset == 0.0 \
                else offset
            if self.guess_offset and not soft_round:
                qoff = helpers.quantization_offset(prior)
                off = qoff if off is None else off + qoff
            return round_ops.round_st(inputs, off)

        y = self.analysis(x)
        y_dist = perturb(y, dither_dist, u_dist)
        y_rate = y_dist if dither_rate == dither_dist else perturb(
            y, dither_rate, u_rate)
        x_hat = self.synthesis(y_dist)
        log_probs = prior.log_prob(y_rate)
        rates = torch.sum(log_probs, dim=-1) / (-math.log(2.0))
        return y_dist, x_hat, rates

    def train_losses(self, x, generator=None, u=None):
        _, x_hat, rates = self.encode_decode(
            x, self.dither[0], self.dither[1], self.soft_round[0],
            generator=generator, u=u)
        return rates, self.distortion_fn(x, x_hat)

    def test_losses(self, x, generator=None, u=None):
        _, x_hat, rates = self.encode_decode(
            x, self.dither[2], self.dither[3], self.soft_round[1],
            generator=generator, u=u)
        return rates, self.distortion_fn(x, x_hat)

    def forward(self, x, training=True, generator=None, u=None):
        """Returns (loss, rate, distortion), each the batch mean."""
        losses = self.train_losses if training else self.test_losses
        rates, distortions = losses(x, generator=generator, u=u)
        return (torch.mean(rates + self.lmbda * distortions),
                torch.mean(rates), torch.mean(distortions))

    @torch.no_grad()
    def quantize_codebook(self, x):
        """Returns (codebook, rates, indexes) over the induced lattice, on
        the model's device: the distinct rounded latents in lexicographic
        order (``np.unique``'s), each with the reconstruction and rate of
        its first occurrence, and each sample's codeword index (int32)."""
        y_hat, x_hat, rates = self.encode_decode(x, False, False, False)
        flat_y = y_hat.reshape(-1, self.ndim_latent)
        _, inverse = torch.unique(flat_y, dim=0, return_inverse=True)
        n = flat_y.shape[0]
        first = torch.full((int(inverse.max()) + 1,), n,
                           dtype=torch.int64, device=flat_y.device)
        first.scatter_reduce_(0, inverse, torch.arange(
            n, device=flat_y.device), reduce="amin")
        codebook = x_hat.reshape(-1, self.ndim_source)[first]
        rates = rates.reshape(-1)[first]
        indexes = inverse.reshape(x.shape[:-1]).to(torch.int32)
        return codebook, rates, indexes


class VECVQModel(nn.Module):
    """Variational entropy-constrained VQ (reference vecvq.py)."""

    def __init__(self, ndim_source, codebook_size, lmbda=1.0,
                 distortion_loss="sse", logit_scale=1.0, init_width=2.0,
                 seed=0):
        super().__init__()
        self.lmbda = float(lmbda)
        self.distortion_loss = distortion_loss
        self.logit_scale = float(logit_scale)
        gen = torch.Generator().manual_seed(int(seed))
        self.codebook = nn.Parameter(
            (torch.rand((codebook_size, ndim_source), generator=gen) - 0.5)
            * init_width)
        # JAX's parameter "logits"; the property ``logits`` scales it.
        self._logits = nn.Parameter(
            torch.randn((codebook_size,), generator=gen)
            * (self.logit_scale / 10))

    @property
    def logits(self):
        return self._logits / self.logit_scale

    def distortion_fn(self, reference, reconstruction):
        diff = torch.square(reference - reconstruction)
        if self.distortion_loss == "sse":
            return torch.sum(diff, dim=-1)
        return torch.mean(diff, dim=-1)

    def all_rd(self, x):
        logits = self.logits
        rates = (torch.logsumexp(logits, 0) - logits) / math.log(2.0)
        distortions = self.distortion_fn(x[..., None, :], self.codebook)
        return rates, distortions

    def forward(self, x, training=True, generator=None, u=None):
        """Returns (loss, rate, distortion) of the hard assignment, each
        the batch mean (the noise arguments are ignored, as in JAX)."""
        del training, generator, u
        rates, distortions = self.all_rd(x)
        indexes = torch.argmin(rates + self.lmbda * distortions, dim=-1)
        r = rates[indexes]
        d = torch.gather(distortions, -1, indexes[..., None])[..., 0]
        return (torch.mean(r + self.lmbda * d), torch.mean(r),
                torch.mean(d))

    def quantize(self, x):
        rates, distortions = self.all_rd(x)
        indexes = torch.argmin(rates + self.lmbda * distortions, dim=-1)
        return self.codebook, rates, indexes.to(torch.int32)


def make_ntc_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """Returns ``step(batch, generator=None, u=None)``: one rate-distortion
    step of an NTCModel or VECVQModel on a batch moved to the model's
    device; returns {"loss", "rate", "distortion"} as 0-d tensors there."""
    device = next(model.parameters()).device

    def step(batch, generator=None, u=None):
        batch = torch.as_tensor(batch, device=device).to(torch.float32)
        optimizer.zero_grad(set_to_none=True)
        loss, rate, dist = model(batch, training=True, generator=generator,
                                 u=u)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "rate": rate.detach(),
                "distortion": dist.detach()}

    return step


def train_ntc(sample_fn, model, steps=2000, batch_size=512,
              learning_rate=1e-3, seed=0, log_every=0, device="cuda"):
    """Rate-distortion training loop (reference compression_model.py).

    ``sample_fn(n, generator)`` returns n source samples on the generator's
    device; one generator on ``device``, seeded with ``seed``, draws the
    batches and the noise.  Moves ``model`` to ``device`` (the card unless
    the caller passes device="cpu") and returns (model, last metrics).
    """
    device = resolve_device(device)
    model = model.to(device)
    step_fn = make_ntc_train_step(
        model, torch.optim.Adam(model.parameters(), lr=learning_rate))
    generator = torch.Generator(device=device).manual_seed(int(seed))
    metrics = None
    for i in range(steps):
        batch = sample_fn(batch_size, generator)
        metrics = step_fn(batch, generator=generator)
        if log_every and i % log_every == 0:
            print({k: float(v) for k, v in metrics.items()}, flush=True)
    return model, metrics


def params_from_jax(tree) -> dict:
    """Converts JAX ``NTCModel`` or ``VECVQModel`` params (the flax dict,
    with or without the top-level "params" key) to the model's
    state_dict."""
    tree = tree.get("params", tree)
    state = {}
    for key, value in tree.items():
        if key in ("analysis", "synthesis"):
            for layer, leaves in value.items():
                for leaf, v in leaves.items():
                    state[f"{key}_mlp.{layer}.{leaf}"] = torch.tensor(
                        np.asarray(v, np.float32))
        elif key == "prior":
            for part in ("matrices", "biases", "factors"):
                for i, v in enumerate(value[part]):
                    state[f"prior_{part}.{i}"] = torch.tensor(
                        np.asarray(v, np.float32))
        else:
            name = "_logits" if key == "logits" and "codebook" in tree \
                else key
            state[name] = torch.tensor(np.asarray(value, np.float32))
    return state
