"""HiFiC at get_config("hific"): its weights from a seed, the program's
model and codec built on them, and the published transforms' flop."""

from __future__ import annotations

from portbench import counts
from portbench import weights as W


def _conv(out, name, k, cin, cout):
    out[f"{name}.kernel"] = W.normal((k, k, cin, cout), W.kernel_std(k, cin))
    out[f"{name}.bias"] = W.const((cout,), 0.0)


def _norm(out, name, c):
    out[f"{name}.gamma"] = W.const((c,), 1.0)
    out[f"{name}.beta"] = W.const((c,), 0.0)


def spec(cfg):
    base, down = cfg["num_filters_base"], cfg["num_down"]
    neck, hyper = cfg["num_filters_bottleneck"], cfg["hyper_filters"]
    top = base * 2**down
    out = {}
    _conv(out, "encoder.Conv_0", 7, 3, base)
    _norm(out, "encoder.ChannelNorm_0", base)
    for i in range(down):
        _conv(out, f"encoder.Conv_{i + 1}", 3, base * 2**i, base * 2 ** (i + 1))
        _norm(out, f"encoder.ChannelNorm_{i + 1}", base * 2 ** (i + 1))
    _conv(out, f"encoder.Conv_{down + 1}", 3, top, neck)
    _norm(out, "decoder.ChannelNorm_0", neck)
    _conv(out, "decoder.Conv_0", 3, neck, top)
    _norm(out, "decoder.ChannelNorm_1", top)
    for b in range(cfg["num_residual_blocks"]):
        for j in range(2):
            _conv(out, f"decoder.block_{b}.Conv_{j}", 3, top, top)
            _norm(out, f"decoder.block_{b}.ChannelNorm_{j}", top)
    filters = top
    for j, scale in enumerate(reversed(range(down))):
        _conv(out, f"decoder.ConvTranspose_{j}", 3, filters, base * 2**scale)
        _norm(out, f"decoder.ChannelNorm_{j + 2}", base * 2**scale)
        filters = base * 2**scale
    _conv(out, "decoder.Conv_1", 7, filters, 3)
    for i, k in enumerate((3, 5, 5)):
        cin = neck if i == 0 else hyper
        out[f"hyper_analysis.layer_{i}.kernel_rdft"] = W.normal(
            W.rdft_shape(cin, hyper, k), W.kernel_std(k, cin))
        out[f"hyper_analysis.layer_{i}.bias"] = W.const((hyper,), 0.0)
    for branch in ("scale", "mean"):
        for i, (k, cout) in enumerate(((5, hyper), (5, hyper), (3, neck))):
            name = f"hyper_synthesis_{branch}.layer_{i}"
            out[f"{name}.kernel"] = W.normal((k, k, hyper, cout),
                                             W.kernel_std(k, hyper))
            out[f"{name}.bias"] = W.const((cout,), 0.0)
    out.update(W.hyperprior(hyper))
    return out


def model(cfg, weights, device):
    """The program's HiFiCModel holding ``weights`` (its own seeded init
    is skipped: every leaf is overwritten)."""
    import torch
    from unittest import mock

    from compression_tpu_torch.models import hific

    hcfg = hific.get_config("hific")._replace(
        num_down=cfg["num_down"], num_filters_base=cfg["num_filters_base"],
        num_filters_bottleneck=cfg["num_filters_bottleneck"],
        num_residual_blocks=cfg["num_residual_blocks"],
        hyper_filters=cfg["hyper_filters"])
    with mock.patch.object(torch.nn.init, "trunc_normal_",
                           lambda t, *a, **k: t):
        m = hific.HiFiCModel(hcfg)
    m = m.to(device)
    m.load_state_dict(weights)
    return m


def codec(cfg, weights, device):
    from compression_tpu_torch.models import hific

    return hific.HiFiCCodec(model(cfg, weights, device), device=device)


def flops(cfg, height, width):
    """Flop of each part of the transforms on one H x W image (multiples
    of 64)."""
    base, down = cfg["num_filters_base"], cfg["num_down"]
    neck, hyper = cfg["num_filters_bottleneck"], cfg["hyper_filters"]
    top = base * 2**down
    p = height * width
    p16 = p >> (2 * down)
    analysis = counts.conv(3, base, 7, p)
    for i in range(down):
        analysis += counts.conv(base * 2**i, base * 2 ** (i + 1), 3,
                                p >> (2 * (i + 1)))
    analysis += counts.conv(top, neck, 3, p16)
    synthesis = (counts.conv(neck, top, 3, p16)
                 + 2 * cfg["num_residual_blocks"] * counts.conv(top, top, 3,
                                                                p16))
    filters = top
    for j, scale in enumerate(reversed(range(down))):
        # A transposed convolution counts its input positions.
        synthesis += counts.conv(filters, base * 2**scale, 3,
                                 p >> (2 * (down - j)))
        filters = base * 2**scale
    synthesis += counts.conv(filters, 3, 7, p)
    hyper_analysis = (counts.conv(neck, hyper, 3, p16)
                      + counts.conv(hyper, hyper, 5, p16 // 4)
                      + counts.conv(hyper, hyper, 5, p16 // 16))
    one = (counts.conv(hyper, hyper, 5, p16 // 16)
           + counts.conv(hyper, hyper, 5, p16 // 4)
           + counts.conv(hyper, neck, 3, p16))
    return dict(analysis=analysis, synthesis=synthesis,
                hyper_analysis=hyper_analysis, hyper_synthesis=2 * one)


def latent_depths(cfg):
    """Channels of (y, z)."""
    return cfg["num_filters_bottleneck"], cfg["hyper_filters"]
