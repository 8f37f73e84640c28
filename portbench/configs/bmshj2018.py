"""bmshj2018 at 192 filters: its weights from a seed, the program's model
and codec built on them, and the published transforms' flop."""

from __future__ import annotations

from portbench import counts
from portbench import weights as W


def spec(cfg):
    n = cfg["num_filters"]
    out = {}
    for part, gdn in (("analysis", "gdn"), ("synthesis", "igdn")):
        for i in range(4):
            cin = 3 if (part == "analysis" and i == 0) else n
            cout = 3 if (part == "synthesis" and i == 3) else n
            out[f"{part}.layer_{i}.kernel_rdft"] = W.normal(
                W.rdft_shape(cin, cout, 5), W.kernel_std(5, cin))
            out[f"{part}.layer_{i}.bias"] = W.const((cout,), 0.0)
            if i < 3:
                out[f"{part}.{gdn}_{i}.reparam_beta"] = W.const(
                    (n,), W.gdn_beta)
                out[f"{part}.{gdn}_{i}.reparam_gamma"] = W.const(
                    (n, n), W.gdn_gamma)
    for i, k in enumerate((3, 5, 5)):
        out[f"hyper_analysis.layer_{i}.kernel_rdft"] = W.normal(
            W.rdft_shape(n, n, k), W.kernel_std(k, n))
        if i < 2:
            out[f"hyper_analysis.layer_{i}.bias"] = W.const((n,), 0.0)
    for i, k in enumerate((5, 5, 3)):
        out[f"hyper_synthesis.layer_{i}.kernel"] = W.normal(
            (k, k, n, n), W.kernel_std(k, n))
        out[f"hyper_synthesis.layer_{i}.bias"] = W.const((n,), 0.0)
    out.update(W.hyperprior(n))
    return out


def model(cfg, weights, device):
    """The program's BMSHJ2018Model holding ``weights`` (its own seeded
    init is skipped: every leaf is overwritten)."""
    import torch
    from unittest import mock

    from compression_tpu_torch.models import bmshj2018

    with mock.patch.object(torch.nn.init, "trunc_normal_",
                           lambda t, *a, **k: t):
        m = bmshj2018.BMSHJ2018Model(
            lmbda=cfg["lmbda"], num_filters=cfg["num_filters"],
            num_scales=cfg["num_scales"], scale_min=cfg["scale_min"],
            scale_max=cfg["scale_max"])
    m = m.to(device)
    m.load_state_dict(weights)
    return m


def codec(cfg, weights, device):
    from compression_tpu_torch.models import bmshj2018

    return bmshj2018.BMSHJ2018Codec(model(cfg, weights, device),
                                    device=device)


def flops(cfg, height, width):
    """Flop of each part of the transforms on one H x W image (multiples
    of 64)."""
    n = cfg["num_filters"]
    analysis = synthesis = 0
    for i in range(4):
        cin = 3 if i == 0 else n
        cout = 3 if i == 3 else n
        big = (height >> i) * (width >> i)
        small = big // 4
        analysis += counts.conv(cin, n, 5, small)
        if i < 3:
            analysis += counts.mix(n, small)
        # synthesis layer i upsamples from 1/16 << i of the image.
        s_in = (height >> (4 - i)) * (width >> (4 - i))
        synthesis += counts.conv(n, cout, 5, s_in)
        if i < 3:
            synthesis += counts.mix(n, 4 * s_in)
    p16 = (height >> 4) * (width >> 4)
    hyper_analysis = (counts.conv(n, n, 3, p16) + counts.conv(n, n, 5, p16 // 4)
                      + counts.conv(n, n, 5, p16 // 16))
    hyper_synthesis = (counts.conv(n, n, 5, p16 // 16)
                       + counts.conv(n, n, 5, p16 // 4)
                       + counts.conv(n, n, 3, p16))
    return dict(analysis=analysis, synthesis=synthesis,
                hyper_analysis=hyper_analysis,
                hyper_synthesis=hyper_synthesis)


def train_step(model, optimizer):
    """The program's training step over ``model``."""
    from compression_tpu_torch.models import bmshj2018

    return bmshj2018.make_train_step(model, optimizer)


def latent_shapes(cfg, batch, height, width):
    """NHWC shapes of (z, y): the noise each training step takes."""
    n = cfg["num_filters"]
    return ((batch, height // 64, width // 64, n),
            (batch, height // 16, width // 16, n))


def latent_depths(cfg):
    """Channels of (y, z)."""
    return cfg["num_filters"], cfg["num_filters"]
