"""Judges an answer of a channel-wise autoregressive codec (ms2020's classic
container: the three shapes, z's stream and one stream a slice) slice by
slice, since a slice can be read only after the slices it depends on.

For one request:

1. z: the reference's analysis and hyper analysis of the image, z rounded
   (about zero: ms2020 codes z without the median's offset), against what
   z's stream holds, read by the plain decoder on tables the reference
   built itself;
2. slice by slice: the reference's mean and scale index of slice i, in
   float64, from the hyper syntheses of the decoded z and from the slices
   *as the container decoded them*; slice i's stream read on the
   reference's own rows, with ``check_codec``'s rule for rows within a
   hair of an integer, against round(y_i - mu_i) of the reference's
   analysis; then the decoded integers plus mu_i plus the reference's LRP
   make the slice that the later slices see;
3. the reference's synthesis of the slices so decoded, in float32 and
   rounded to uint8, against the image ``decompress`` returned.

The numbers are ``check_codec``'s: ``latent_mismatch`` (the share of z's
and the slices' values that differ), ``pixel_mismatch`` and
``broken_streams``; ``ambiguous_rows`` is reported beside them.
``control`` gives the same numbers of the reference computed in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import check_codec
from portbench.reference import container as container_lib
from portbench.reference import distributions
from portbench.reference import ops as ops_lib
from portbench.reference import tables as tables_lib

BROKEN = dict(latent_mismatch=1.0, pixel_mismatch=1.0, broken_streams=1,
              ambiguous_rows=0)


class SliceTables:
    """The y table (one row a scale index) and the z table, whose rows
    sample the prior at the integers (z's quantization offset is zero)."""

    def __init__(self, cfg, w):
        self.y = tables_lib.scale_table(cfg["scale_min"], cfg["scale_max"],
                                        cfg["num_scales"],
                                        cfg["range_coder_precision"])
        params = distributions.hyperprior_params(w)
        prior = distributions.DeepFactorized(
            {k: [t.detach().float().cpu() for t in v]
             for k, v in params.items()})
        lower, upper = prior.tails(tables_lib.TAIL_MASS)
        zero = torch.zeros((), dtype=torch.float32)
        self.z = tables_lib._quantized_rows(
            prior.noisy_prob, lower, upper, zero,
            cfg["range_coder_precision"])
        self.num_scales = cfg["num_scales"]


def _nhwc(t):
    """[1, C, H, W] -> flat NHWC numpy."""
    return t[0].permute(1, 2, 0).reshape(-1).cpu().numpy()


def _from_nhwc(values, h, w, c, device, dtype=torch.float32):
    t = torch.as_tensor(np.asarray(values).reshape(h, w, c), dtype=dtype,
                        device=device)
    return t.permute(2, 0, 1)[None]


def judge(model, cfg, w, tables, image, container, decoded, device):
    """The numbers for one request (see the module's docstring).

    Args:
      model: ``reference.ms2020``.
      cfg: the configuration.
      w: the weights, on ``device``.
      tables: ``SliceTables`` of these weights.
      image: the request's uint8 [H, W, 3] image (numpy).
      container: the bytes ``compress`` returned.
      decoded: the uint8 [H, W, 3] image ``decompress`` returned.
    """
    ops = ops_lib.Ops(tf32=False)
    with torch.no_grad(), ops.precision():
        x = torch.as_tensor(np.asarray(image), device=device)[None]
        y = model.analysis(ops, w, x)
        z = model.hyper_analysis(ops, w, y)
    ns = model.num_slices(w)
    model_id, tensors = container_lib.read(container)
    if model_id != model.MODEL_ID or len(tensors) != 4 + ns:
        return dict(BROKEN)
    _, cz, hz, wz = z.shape
    _, cy, hy, wy = y.shape
    depth = cy // ns
    z_expected = np.round(_nhwc(z)).astype(np.int64)
    z_vals, mismatched, broken, _ = check_codec._decode_latent(
        tensors[3], check_codec._streams(tensors[3], hz, wz, cz, "classic"),
        tables.z, np.arange(z_expected.size) % cz, {}, z_expected, None)
    z_hat = _from_nhwc(z_vals, hz, wz, cz, device)
    counts = dict(mismatched=mismatched, broken=broken, ambiguous=0)

    def integers(i, mu, sigma):
        strings = tensors[4 + i]
        y_i = y[:, i * depth: (i + 1) * depth]
        expected = _nhwc(torch.round(y_i - mu.to(torch.float32))).astype(
            np.int64)
        rows, alternatives = check_codec._rows(_nhwc(sigma),
                                               tables.num_scales)
        vals, mis, brk, amb = check_codec._decode_latent(
            strings, check_codec._streams(strings, hy, wy, depth, "classic"),
            tables.y, rows, alternatives, expected, None)
        counts["mismatched"] += mis
        counts["broken"] += brk
        counts["ambiguous"] += amb
        return _from_nhwc(vals, hy, wy, depth, device, mu.dtype)

    with torch.no_grad(), ops.precision():
        y_hat = model.slice_loop(ops, w, z_hat, (hy, wy), integers,
                                 torch.float64)
        x_ref = check_codec._to_uint8(model.synthesis(
            ops, w, y_hat.to(torch.float32)))
    decoded = np.asarray(decoded)
    h, w_ = decoded.shape[:2]
    pixel = float(np.mean(x_ref[:h, :w_] != decoded)) \
        if x_ref[:h, :w_].shape == decoded.shape else 1.0
    return dict(latent_mismatch=counts["mismatched"] / (z.numel() + y.numel()),
                pixel_mismatch=pixel, broken_streams=int(counts["broken"]),
                ambiguous_rows=int(counts["ambiguous"]))


def control(model, cfg, w, tables, image, device):
    """The control's numbers for one image: the reference computed in
    TF32 stands in the program's place.  Its integers (z about zero, each
    slice about its own mean from its own earlier slices) are set against
    the float32 reference's, and its synthesis of its own slices against
    the float32 synthesis of the same slices."""
    lo, hi = ops_lib.Ops(tf32=True), ops_lib.Ops(tf32=False)
    x = torch.as_tensor(np.asarray(image), device=device)[None]

    def latents(ops):
        ints = []

        def integers(i, mu, sigma):
            depth = mu.shape[1]
            ints.append(model.quantize(y[:, i * depth: (i + 1) * depth], mu))
            return ints[-1]

        with torch.no_grad(), ops.precision():
            y = model.analysis(ops, w, x)
            z_int = torch.round(model.hyper_analysis(ops, w, y))
            y_hat = model.slice_loop(ops, w, z_int, y.shape[2:], integers)
        return z_int, torch.cat(ints, dim=1), y_hat

    z_c, y_c, y_hat = latents(lo)
    z_r, y_r, _ = latents(hi)
    mismatch = (int((z_c != z_r).sum()) + int((y_c != y_r).sum())) / (
        z_r.numel() + y_r.numel())
    with torch.no_grad():
        with lo.precision():
            x_c = check_codec._to_uint8(model.synthesis(lo, w, y_hat))
        with hi.precision():
            x_r = check_codec._to_uint8(model.synthesis(hi, w, y_hat))
    return dict(latent_mismatch=mismatch,
                pixel_mismatch=float(np.mean(x_c != x_r)))
