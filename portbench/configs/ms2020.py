"""ms2020 at TFC's widths: its weights from a seed, the program's model and
codec built on them, and the published transforms' flop."""

from __future__ import annotations

from portbench import counts
from portbench import weights as W


def _rdft(out, name, k, cin, cout, bias=True):
    out[f"{name}.kernel_rdft"] = W.normal(W.rdft_shape(cin, cout, k),
                                          W.kernel_std(k, cin))
    if bias:
        out[f"{name}.bias"] = W.const((cout,), 0.0)


def _plain(out, name, k, cin, cout):
    out[f"{name}.kernel"] = W.normal((k, k, cin, cout), W.kernel_std(k, cin))
    out[f"{name}.bias"] = W.const((cout,), 0.0)


def _supports(cfg):
    """Input channels of each slice's mean and scale predictors."""
    depth = cfg["latent_depth"] // cfg["num_slices"]
    return [cfg["hyper_synthesis_widths"][-1]
            + depth * min(i, cfg["max_support_slices"])
            for i in range(cfg["num_slices"])]


def spec(cfg):
    n, c = cfg["num_filters"], cfg["latent_depth"]
    hz = cfg["hyperprior_depth"]
    out = {}
    for part, gdn in (("analysis", "gdn"), ("synthesis", "igdn")):
        for i in range(4):
            cin = {("analysis", 0): 3, ("synthesis", 0): c}.get((part, i), n)
            cout = {("analysis", 3): c, ("synthesis", 3): 3}.get((part, i), n)
            _rdft(out, f"{part}.layer_{i}", 5, cin, cout)
            if i < 3:
                out[f"{part}.{gdn}_{i}.reparam_beta"] = W.const(
                    (n,), W.gdn_beta)
                out[f"{part}.{gdn}_{i}.reparam_gamma"] = W.const(
                    (n, n), W.gdn_gamma)
    ha = [c] + list(cfg["hyper_analysis_widths"]) + [hz]
    for i, k in enumerate((3, 5, 5)):
        _rdft(out, f"hyper_analysis.layer_{i}", k, ha[i], ha[i + 1],
              bias=i < 2)
    hs = [hz] + list(cfg["hyper_synthesis_widths"])
    for branch in ("mean", "scale"):
        for i, k in enumerate((5, 5, 3)):
            _plain(out, f"hyper_synthesis_{branch}.layer_{i}", k, hs[i],
                   hs[i + 1])
    depth = c // cfg["num_slices"]
    for i, support in enumerate(_supports(cfg)):
        for group, extra in (("cc_mean", 0), ("cc_scale", 0), ("lrp", depth)):
            widths = [support + extra] + list(cfg["slice_widths"]) + [depth]
            for j, k in enumerate((5, 5, 3)):
                _plain(out, f"{group}_{i}.layer_{j}", k, widths[j],
                       widths[j + 1])
    out.update(W.hyperprior(hz))
    return out


def model(cfg, weights, device):
    """The program's MS2020Model holding ``weights`` (its own seeded init
    is skipped: every leaf is overwritten)."""
    import torch
    from unittest import mock

    from compression_tpu_torch.models import ms2020

    with mock.patch.object(torch.nn.init, "trunc_normal_",
                           lambda t, *a, **k: t):
        m = ms2020.MS2020Model(
            lmbda=cfg["lmbda"], num_filters=cfg["num_filters"],
            latent_depth=cfg["latent_depth"],
            hyperprior_depth=cfg["hyperprior_depth"],
            num_slices=cfg["num_slices"],
            max_support_slices=cfg["max_support_slices"],
            num_scales=cfg["num_scales"], scale_min=cfg["scale_min"],
            scale_max=cfg["scale_max"],
            ha_widths=tuple(cfg["hyper_analysis_widths"]),
            hs_widths=tuple(cfg["hyper_synthesis_widths"]),
            slice_widths=tuple(cfg["slice_widths"]))
    m = m.to(device)
    m.load_state_dict(weights)
    return m


def codec(cfg, weights, device):
    from compression_tpu_torch.models import ms2020

    return ms2020.MS2020Codec(model(cfg, weights, device), device=device)


def flops(cfg, height, width):
    """Flop of each part of the transforms on one H x W image (multiples
    of 64).  ``hyper_synthesis`` holds both hyper syntheses and the 3 x
    num_slices slice predictors (mean, scale and LRP), so that a reader's
    compress (analysis, hyper analysis, hyper synthesis) and decompress
    (hyper synthesis, synthesis) count the slice loop that both run."""
    n, c = cfg["num_filters"], cfg["latent_depth"]
    hz = cfg["hyperprior_depth"]
    analysis = synthesis = 0
    for i in range(4):
        cin = 3 if i == 0 else n
        cout = c if i == 3 else n
        small = (height >> (i + 1)) * (width >> (i + 1))
        analysis += counts.conv(cin, cout, 5, small)
        if i < 3:
            analysis += counts.mix(n, small)
        # synthesis layer i upsamples from 1/16 << i of the image.
        s_in = (height >> (4 - i)) * (width >> (4 - i))
        synthesis += counts.conv(c if i == 0 else n, 3 if i == 3 else n, 5,
                                 s_in)
        if i < 3:
            synthesis += counts.mix(n, 4 * s_in)
    p16 = (height >> 4) * (width >> 4)
    ha = [c] + list(cfg["hyper_analysis_widths"]) + [hz]
    hyper_analysis = (counts.conv(ha[0], ha[1], 3, p16)
                      + counts.conv(ha[1], ha[2], 5, p16 // 4)
                      + counts.conv(ha[2], ha[3], 5, p16 // 16))
    hs = [hz] + list(cfg["hyper_synthesis_widths"])
    # Transposed layers count their input positions.
    one = (counts.conv(hs[0], hs[1], 5, p16 // 16)
           + counts.conv(hs[1], hs[2], 5, p16 // 4)
           + counts.conv(hs[2], hs[3], 3, p16))
    depth = c // cfg["num_slices"]
    w1, w2 = cfg["slice_widths"]
    slices = 0
    for support in _supports(cfg):
        for cin in (support, support, support + depth):
            slices += (counts.conv(cin, w1, 5, p16)
                       + counts.conv(w1, w2, 5, p16)
                       + counts.conv(w2, depth, 3, p16))
    return dict(analysis=analysis, synthesis=synthesis,
                hyper_analysis=hyper_analysis,
                hyper_synthesis=2 * one + slices)


def latent_depths(cfg):
    """Channels of (y, z)."""
    return cfg["latent_depth"], cfg["hyperprior_depth"]
