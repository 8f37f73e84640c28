"""The priors of the two models' entropy models, from TFC's equations, in
float32 (the configurations' precision):

* the scale table's NoisyNormal (a zero-mean normal convolved with a unit
  box), its tails by the normal's quantile;
* the hyperprior's NoisyDeepFactorized (Ballé et al. 2018, appendix 6.1:
  a per-channel monotone MLP gives the logits of the cumulative), its
  tails and its median by TFC's Adam-like fixed-point iteration
  (python/distributions/helpers.py ``estimate_tails``).

The range coder needs the sender's CDF tables bit for bit, so the table
side (``*_prob``, the tails, the median) follows TFC's order of float32
operations; the training side (``*_log_prob``) carries gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ndtr(x):
    """Standard normal CDF, precise in both tails: erf near 0, erfc beyond
    (cephes' ndtr)."""
    x = x * math.sqrt(0.5)
    z = torch.abs(x)
    return torch.where(
        z < math.sqrt(0.5), 0.5 + 0.5 * torch.erf(x),
        torch.where(x > 0, 1.0 - 0.5 * torch.erfc(z), 0.5 * torch.erfc(z)))


def scale_table(scale_min, scale_max, num_scales, index):
    """Scale of (float32) table index i: exp(log(min) + i (log(max) -
    log(min)) / (levels - 1))."""
    offset = math.log(scale_min)
    factor = (math.log(scale_max) - math.log(scale_min)) / (num_scales - 1.0)
    return torch.exp(offset + factor * index)


def _box(sf_plus, sf_minus, cdf_plus, cdf_minus):
    """Mass of [y - .5, y + .5]: from the survival function right of the
    median, from the CDF left of it."""
    return torch.where(sf_plus < cdf_plus, sf_minus - sf_plus,
                       cdf_plus - cdf_minus)


def _log_box(logsf_plus, logsf_minus, logcdf_plus, logcdf_minus):
    """log of ``_box``'s mass, as log(exp(big) - exp(small))."""
    cond = logsf_plus < logcdf_plus
    big = torch.where(cond, logsf_minus, logcdf_plus)
    small = torch.where(cond, logsf_plus, logcdf_minus)
    return torch.where(torch.isinf(big), big,
                       torch.log1p(-torch.exp(small - big)) + big)


# -- NoisyNormal (zero mean) ------------------------------------------------
def noisy_normal_prob(y, scale):
    loc = torch.zeros((), dtype=scale.dtype, device=scale.device)

    def std(v):
        return (v - loc) / scale

    return _box(ndtr(-std(y + 0.5)), ndtr(-std(y - 0.5)),
                ndtr(std(y + 0.5)), ndtr(std(y - 0.5)))


def noisy_normal_log_prob(y, scale):
    def std(v):
        return v / scale

    log_ndtr = torch.special.log_ndtr
    return _log_box(log_ndtr(-std(y + 0.5)), log_ndtr(-std(y - 0.5)),
                    log_ndtr(std(y + 0.5)), log_ndtr(std(y - 0.5)))


def normal_quantile(scale, p):
    loc = torch.zeros((), dtype=scale.dtype, device=scale.device)
    return loc + scale * torch.special.ndtri(
        torch.as_tensor(p, dtype=scale.dtype, device=scale.device))


# -- deep factorized --------------------------------------------------------
def hyperprior_params(w):
    """The hyperprior's {"matrices", "biases", "factors"} lists out of the
    checkpoint's names (``hyperprior_matrices.0``, ...)."""
    n = len([k for k in w if k.startswith("hyperprior_matrices.")])
    return {k: [w[f"hyperprior_{k}.{i}"] for i in range(m)]
            for k, m in (("matrices", n), ("biases", n), ("factors", n - 1))}


class DeepFactorized:
    """Per-channel monotone MLP over ``params`` ({"matrices", "biases",
    "factors"}: lists of [C, o, i], [C, o, 1], [C, o, 1] tensors)."""

    def __init__(self, params):
        self.params = params
        self.channels = int(params["matrices"][0].shape[0])

    def logits_cumulative(self, inputs):
        """Logits of the CDF of inputs [..., C] (broadcast against C)."""
        shape = torch.broadcast_shapes(inputs.shape, (self.channels,))
        inputs = inputs.expand(shape)
        logits = inputs.reshape(-1, 1, self.channels).permute(2, 1, 0)
        n = len(self.params["factors"])
        for i in range(n + 1):
            logits = torch.matmul(F.softplus(self.params["matrices"][i]),
                                  logits)
            logits = logits + self.params["biases"][i]
            if i < n:
                logits = logits + torch.tanh(
                    self.params["factors"][i]) * torch.tanh(logits)
        return logits.permute(2, 1, 0).reshape(shape)

    def noisy_prob(self, y):
        lp = self.logits_cumulative(y + 0.5)
        lm = self.logits_cumulative(y - 0.5)
        return _box(torch.sigmoid(-lp), torch.sigmoid(-lm),
                    torch.sigmoid(lp), torch.sigmoid(lm))

    def noisy_log_prob(self, y):
        lp = self.logits_cumulative(y + 0.5)
        lm = self.logits_cumulative(y - 0.5)
        return _log_box(F.logsigmoid(-lp), F.logsigmoid(-lm),
                        F.logsigmoid(lp), F.logsigmoid(lm))

    def _solve(self, target):
        return estimate_tails(self.logits_cumulative, target,
                              (self.channels,))

    def quantization_offset(self):
        """The median's distance to the nearest integer (TFC's offset
        heuristic)."""
        median = self._solve(0.0).detach()
        return median - torch.round(median)

    def tails(self, tail_mass):
        """(lower, upper): where the CDF is tail_mass / 2 and 1 - it."""
        target = math.log(tail_mass / 2 / (1.0 - tail_mass / 2))
        return self._solve(target).detach(), self._solve(-target).detach()


def estimate_tails(func, target, shape):
    """x (elementwise) with func(x) = target: TFC's iteration, Adam-like
    steps with halving averages and lr 0.1 / sqrt(count + 1), counting from
    the first sign change of the gradient, until every loss is at most
    1e-8 or every count reaches 100; returns the best iterate."""
    kw = dict(dtype=torch.float32, device="cpu")
    target = torch.as_tensor(target, **kw)
    big = torch.finfo(torch.float32).max
    tails = torch.zeros(shape, **kw)
    m = torch.zeros(shape, **kw)
    v = torch.ones(shape, **kw)
    loss = torch.full(shape, big, **kw)
    count = torch.zeros(shape, dtype=torch.int32)
    best_tails = tails
    best_loss = torch.full(shape, big, **kw)
    while bool(loss.max() > 1e-8) and bool(count.min() < 100):
        t = tails.detach().requires_grad_(True)
        with torch.enable_grad():
            step_loss = torch.abs(func(t) - target)
            (grad,) = torch.autograd.grad(step_loss.sum(), t)
        loss = step_loss.detach()
        better = loss < best_loss
        best_tails = torch.where(better, tails, best_tails)
        best_loss = torch.where(better, loss, best_loss)
        new_m = (m + grad) / 2
        v = (v + torch.square(grad)) / 2
        k = torch.sqrt((count + 1).to(torch.float32))
        tails = tails - 0.1 * new_m / (k * torch.sqrt(v) + 1e-20)
        count = torch.where((count > 0) | (m * grad < 0), count + 1, count)
        m = new_m
    return best_tails
