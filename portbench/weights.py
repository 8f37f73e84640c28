"""Weights and inputs made on the device from a run's seed, in a few large
calls: every normal leaf is a slice of one draw, every uniform leaf a
slice of another."""

from __future__ import annotations

import math

import torch


def sub_seed(seed, tag):
    """A seed for one use (weights, images, noise) of a run's seed."""
    return (int(seed) * 1_000_003 + int(tag)) % (1 << 63)


def normal(shape, std):
    return ("normal", tuple(shape), float(std))


def uniform(shape, low, high):
    return ("uniform", tuple(shape), (float(low), float(high)))


def const(shape, value):
    """A constant leaf; ``value`` is a number or a function of the shape
    that returns a CPU tensor."""
    return ("const", tuple(shape), value)


def make(spec, seed, device):
    """{name: float32 tensor on ``device``} for a spec {name: leaf}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for kind in ("normal", "uniform"):
        names = sorted(n for n, leaf in spec.items() if leaf[0] == kind)
        total = sum(math.prod(spec[n][1]) for n in names)
        if not total:
            continue
        draw = (torch.randn if kind == "normal" else torch.rand)(
            total, generator=gen, device=device)
        at = 0
        for n in names:
            _, shape, arg = spec[n]
            size = math.prod(shape)
            piece = draw[at: at + size].reshape(shape)
            at += size
            if kind == "normal":
                out[n] = piece * arg
            else:
                out[n] = piece * (arg[1] - arg[0]) + arg[0]
    for n, (kind, shape, value) in spec.items():
        if kind == "const":
            if callable(value):
                out[n] = value(shape).to(device=device, dtype=torch.float32)
            else:
                out[n] = torch.full(shape, float(value), device=device)
    return out


def kernel_std(k, cin):
    """1 / sqrt(fan-in) of a k x k kernel over ``cin`` channels."""
    return (1.0 / (k * k * cin)) ** 0.5


def rdft_shape(cin, cout, k):
    return (2, cin, cout, k, k // 2 + 1)


_PEDESTAL = (2.0**-18) ** 2


def gdn_beta(shape):
    """TFC's GDN beta at 1, in its stored form sqrt(beta + pedestal)."""
    return torch.sqrt(torch.ones(shape) + _PEDESTAL)


def gdn_gamma(shape):
    """TFC's GDN gamma at 0.1 I, in its stored form."""
    return torch.sqrt(0.1 * torch.eye(shape[0]) + _PEDESTAL)


def hyperprior(channels, init_scale=10.0, filters=(3, 3)):
    """TFC's deep factorized prior at its initializers: constant matrices
    (softplus^-1 of 1 / scale / filters), U(-0.5, 0.5) biases, zero
    factors."""
    dims = (1,) + tuple(filters) + (1,)
    scale = init_scale ** (1 / (len(filters) + 1))
    spec = {}
    for i in range(len(filters) + 1):
        value = math.log(math.expm1(1 / scale / dims[i + 1]))
        spec[f"hyperprior_matrices.{i}"] = const(
            (channels, dims[i + 1], dims[i]), value)
        spec[f"hyperprior_biases.{i}"] = uniform((channels, dims[i + 1], 1),
                                                 -0.5, 0.5)
        if i < len(filters):
            spec[f"hyperprior_factors.{i}"] = const(
                (channels, dims[i + 1], 1), 0.0)
    return spec
