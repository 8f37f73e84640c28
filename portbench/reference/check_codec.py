"""Judges a codec's answers: what ``compress`` wrote for an image, and what
``decompress`` made of it, against the plain reference.

Stage by stage, for one request:

1. the encoder: the reference's analysis and hyper analysis of the image,
   quantized (z about its median's offset, y about its location), against
   what the container holds, decoded by the plain decoder with tables
   the reference built itself;
2. the decoder: the reference's synthesis of the latents the container
   holds, rounded to uint8, against the image ``decompress`` returned.

The numbers: the share of latent values that differ (``latent_mismatch``),
the share of the image's uint8 values that differ (``pixel_mismatch``),
and the streams that did not decode to their end (``broken_streams``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import coder
from portbench.reference import container as container_lib
from portbench.reference import distributions
from portbench.reference import ops as ops_lib
from portbench.reference import tables as tables_lib

# Half-width of the band around an integer in which the sender's float32
# scale index may fall on the other side of the integer than the
# reference's float64 one (the two differ by ~1e-5 at these sizes).
AMBIGUITY = 5e-4


class CodecTables:
    """The y and z tables and z's offset, built from the configuration and
    the weights."""

    def __init__(self, cfg, w):
        self.y = tables_lib.scale_table(cfg["scale_min"], cfg["scale_max"],
                                        cfg["num_scales"],
                                        cfg["range_coder_precision"])
        self.z, self.z_offset = tables_lib.hyperprior_table(
            distributions.hyperprior_params(w), cfg["range_coder_precision"])
        self.num_scales = cfg["num_scales"]


def _rows(index, num_scales):
    """Nominal rows (the integer part of the clipped index) and, where the
    index lies within AMBIGUITY of an integer k in [1, num_scales - 1],
    the row on the other side of k."""
    idx = np.clip(index, 0.0, num_scales - 1.0)
    rows = idx.astype(np.int64)
    k = np.rint(idx)
    near = ((np.abs(index - k) < AMBIGUITY) & (k >= 1)
            & (k <= num_scales - 1))
    alt = np.where(rows == k, k - 1, k).astype(np.int64)
    return rows, {int(j): int(alt[j]) for j in np.flatnonzero(near)}


def _streams(strings, h, w, c, layout):
    """Element positions (flat NHWC indexes) of each stream: the classic
    container's one stream of all of it, the native one's H * k streams of
    (W / k) * C."""
    flat = np.arange(h * w * c).reshape(h, w, c)
    if layout == "classic":
        return [flat.reshape(-1)]
    k = len(strings) // h
    return list(flat.reshape(h * k, (w // k) * c))


def _sidecars(pairs, vals, num_streams):
    out = [dict() for _ in range(num_streams)]
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    for (s, e), v in zip(pairs, vals):
        if not 0 <= s < num_streams:
            return None
        out[s][int(e)] = int(v)
    return out


def _decode_latent(strings, positions, table, rows, alternatives, expected,
                   sidecars):
    """Decoded values (flat NHWC, int64), mismatches against ``expected``,
    broken streams, ambiguous rows."""
    values = expected.copy()
    broken = ambiguous = 0
    mismatched = 0
    if len(strings) != len(positions):
        return values, expected.size, len(strings) + 1, 0
    for s, (data, pos) in enumerate(zip(strings, positions)):
        alt = {i: alternatives[int(p)] for i, p in enumerate(pos)
               if int(p) in alternatives}
        got, ok, amb = coder.decode_stream(
            data, table, [int(r) for r in rows[pos]],
            [int(e) for e in expected[pos]], alt,
            None if sidecars is None else sidecars[s])
        ambiguous += amb
        broken += not ok
        for i, v in enumerate(got):
            if v is None:
                mismatched += len(got) - i
                break
            values[pos[i]] = v
            mismatched += v != expected[pos[i]]
    return values, mismatched, broken, ambiguous


def judge(model, cfg, w, tables, image, container, decoded, device):
    """The numbers for one request (see the module's docstring).

    Args:
      model: ``reference.bmshj2018`` or ``reference.hific``.
      cfg: the configuration (its table settings).
      w: the weights, on ``device``.
      tables: ``CodecTables`` of these weights.
      image: the request's uint8 [H, W, 3] image (numpy).
      container: the bytes ``compress`` returned.
      decoded: the uint8 [H, W, 3] image ``decompress`` returned.
    """
    ops = ops_lib.Ops(tf32=False)
    with torch.no_grad(), ops.precision():
        x = torch.as_tensor(np.asarray(image), device=device)[None]
        y = model.analysis(ops, w, x)
        z = model.hyper_analysis(ops, w, y)
    model_id, tensors = container_lib.read(container)
    if model_id != model.MODEL_ID or len(tensors) not in (5, 9):
        return dict(latent_mismatch=1.0, pixel_mismatch=1.0,
                    broken_streams=1, ambiguous_rows=0)
    layout = "classic" if len(tensors) == 5 else "native"
    y_strings, z_strings = tensors[0], tensors[1]
    _, cz, hz, wz = z.shape
    _, cy, hy, wy = y.shape
    z_off = tables.z_offset.numpy().astype(np.float32)
    z_nhwc = z[0].permute(1, 2, 0).cpu().numpy()
    z_expected = np.round(z_nhwc - z_off).astype(np.int64).reshape(-1)
    z_pos = _streams(z_strings, hz, wz, cz, layout)
    y_pos = _streams(y_strings, hy, wy, cy, layout)
    z_side = y_side = None
    if layout == "native":
        z_side = _sidecars(tensors[7], tensors[8], len(z_strings))
        y_side = _sidecars(tensors[5], tensors[6], len(y_strings))
        if z_side is None or y_side is None:
            return dict(latent_mismatch=1.0, pixel_mismatch=1.0,
                        broken_streams=1, ambiguous_rows=0)
    z_rows = np.arange(z_expected.size) % cz
    z_vals, z_mis, z_broken, _ = _decode_latent(
        z_strings, z_pos, tables.z, z_rows, {}, z_expected, z_side)
    z_hat = (z_vals.reshape(hz, wz, cz).astype(np.float32) + z_off)
    z_hat = torch.as_tensor(z_hat, device=device).permute(2, 0, 1)[None]
    with torch.no_grad(), ops.precision():
        index, loc = model.y_params(ops, w, z_hat, (hy, wy))
    index = index[0].permute(1, 2, 0).reshape(-1).cpu().numpy()
    loc32 = None if loc is None else loc.to(torch.float32)
    y_nhwc = y[0].permute(1, 2, 0).reshape(-1)
    if loc32 is not None:
        y_nhwc = y_nhwc - loc32[0].permute(1, 2, 0).reshape(-1)
    y_expected = torch.round(y_nhwc).to(torch.int64).cpu().numpy()
    rows, alternatives = _rows(index, tables.num_scales)
    y_vals, y_mis, y_broken, ambiguous = _decode_latent(
        y_strings, y_pos, tables.y, rows, alternatives, y_expected, y_side)
    y_hat = torch.as_tensor(y_vals.astype(np.float32), device=device)
    y_hat = y_hat.reshape(hy, wy, cy).permute(2, 0, 1)[None]
    if loc32 is not None:
        y_hat = y_hat + loc32
    with torch.no_grad(), ops.precision():
        x_ref = _to_uint8(model.synthesis(ops, w, y_hat))
    decoded = np.asarray(decoded)
    h, w_ = decoded.shape[:2]
    pixel = float(np.mean(x_ref[:h, :w_] != decoded)) \
        if x_ref[:h, :w_].shape == decoded.shape else 1.0
    total = z_expected.size + y_expected.size
    return dict(latent_mismatch=(z_mis + y_mis) / total,
                pixel_mismatch=pixel,
                broken_streams=int(z_broken + y_broken),
                ambiguous_rows=int(ambiguous))


def _to_uint8(x_hat):
    """[1, 3, H, W] float -> uint8 [H, W, 3] numpy: rounded, clipped."""
    x = torch.clamp(torch.round(x_hat), 0, 255).to(torch.uint8)
    return x[0].permute(1, 2, 0).cpu().numpy()


def control(model, cfg, w, tables, image, device):
    """The control's numbers for one image: the reference computed in
    TF32 stands in the program's place.  Its quantized latents (z about
    the offset, y about its own location from its own z) are set against
    the float32 reference's, and its synthesis of them against the float32
    synthesis of the same latents."""
    lo, hi = ops_lib.Ops(tf32=True), ops_lib.Ops(tf32=False)
    x = torch.as_tensor(np.asarray(image), device=device)[None]
    z_off = tables.z_offset.to(device)[None, :, None, None]

    def latents(ops):
        with torch.no_grad(), ops.precision():
            y = model.analysis(ops, w, x)
            z = model.hyper_analysis(ops, w, y)
            z_int = torch.round(z - z_off)
            _, loc = model.y_params(ops, w, z_int + z_off, y.shape[2:],
                                    torch.float32)
            y_int = torch.round(y if loc is None else y - loc)
        return z_int, y_int, loc

    z_c, y_c, loc_c = latents(lo)
    z_r, y_r, _ = latents(hi)
    mismatch = (int((z_c != z_r).sum()) + int((y_c != y_r).sum())) / (
        z_r.numel() + y_r.numel())
    y_hat = y_c if loc_c is None else y_c + loc_c
    with torch.no_grad():
        with lo.precision():
            x_c = _to_uint8(model.synthesis(lo, w, y_hat))
        with hi.precision():
            x_r = _to_uint8(model.synthesis(hi, w, y_hat))
    return dict(latent_mismatch=mismatch,
                pixel_mismatch=float(np.mean(x_c != x_r)))
