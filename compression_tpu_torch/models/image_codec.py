"""The shell the image codecs share (``bls2017.BLS2017Codec``,
``bmshj2018.BMSHJ2018Codec`` and its ``hific.HiFiCCodec``,
``ms2020.MS2020Codec``): the entry points, the upload, the synthesis to
uint8, the finish, and the host side of both containers.

Each codec writes and reads two containers: the reference's classic .tfci
one (``compress``: reference-format streams, escapes in-stream) and the
native one (``compress_native``, ``compress_native_many``: one stream per
latent row block plus an escape sidecar, ``models/native_format.py``).
``decompress`` and ``decompress_native_many`` read both, told apart by the
tensor count; ``reconstruct`` skips the coder.  A codec supplies what is
its own through these names:

- ``num_classic_tensors``, ``num_native_tensors``: its containers' sizes;
- ``_y_em``: the y entropy model, whose ``decode_sanity_check`` decides
  whether ``_finish`` reads the decodes' sanity flags;
- ``_classic_fields(x)``: the classic container's fields of an uploaded
  image;
- ``_encode_native(x)``: launches the transforms and sidecar encodes of an
  uploaded image, returns device results without waiting for them;
- ``_native_fields(encoded)``: the native container's fields of an
  ``_encode_native`` result, each latent fetched by ``_fetch``;
- ``_decode_classic(packed)``, ``_decode_native(packed)``: launch a
  container's decodes (streams by ``_classic_streams`` /
  ``_native_streams``), return (y_hat [1, h, w, c], sanity, (H, W)) on the
  device without waiting;
- ``_quantized_latent(x)``: the latent ``reconstruct`` synthesizes.

The float path runs in full float32: on CUDA, TF32 is switched off for
cuDNN and matmuls and cuDNN is made deterministic, so that every entry point
shares one transform path and ``decompress(compress(x))`` and
``decompress(compress_native(x))`` equal ``reconstruct(x)`` exactly.

Spans (``util/profiling.py``, recorded only under a profiler): the entries
``codec.compress``, ``codec.compress_native``, ``codec.decompress`` and
``codec.compress_native_many`` / ``codec.decompress_native_many`` (a
``codec.image`` an image, a request of its own that its ``container.pack``
or ``codec.finish`` resumes), ``codec.upload``, ``codec.finish``,
``transforms.synthesis``, ``container.pack`` / ``.parse``; the codecs add
``transforms.analysis`` and their ``entropy.*`` spans.
"""

from __future__ import annotations

import numpy as np
import torch

from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import native_format
from compression_tpu_torch.util import profiling
from compression_tpu_torch.util.device import resolve_device
from compression_tpu_torch.util.packed_tensors import PackedTensors

__all__ = ["ImageCodec"]


class ImageCodec:
    """Entry points and container host work of an image codec over
    ``model`` (moved to ``device``, "cuda" unless the caller asks for the
    CPU); the model gives ``decode`` (y_hat -> image on the 0-255 scale)."""

    MODEL_ID = None

    def __init__(self, model, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.model = model.to(self.device).eval()

    # -- shared transform path --------------------------------------------
    def _upload(self, x):
        with profiling.span("codec", "upload"):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if x.dtype != torch.uint8 or x.ndim != 3 or x.shape[-1] != 3:
                raise ValueError("expected a uint8 [H, W, 3] image")
            if x.device == self.device:
                return x
            with profiling.wait("upload"):
                return x.to(self.device)

    def _synthesis_u8(self, y_hat):
        with profiling.span("transforms", "synthesis", "dispatch"):
            x_hat = self.model.decode(y_hat)
            return torch.clamp(torch.round(x_hat), 0, 255).to(torch.uint8)

    # -- compress ----------------------------------------------------------
    def _pack(self, fields) -> bytes:
        packed = PackedTensors()
        packed.model = self.MODEL_ID
        packed.pack(fields)
        return packed.string

    @torch.no_grad()
    def compress(self, x) -> bytes:
        """uint8 [H, W, 3] image -> classic .tfci container bytes: each
        latent (or slice) in one reference-format stream, escapes in-stream
        (the reference's format, byte-identical to the JAX package's)."""
        with profiling.span("codec", "compress", request=True):
            fields = self._classic_fields(self._upload(x))
            with profiling.span("container", "pack"):
                return self._pack(fields)

    @staticmethod
    def _fetch(out, w, c):
        """Copies a sidecar encode's (buf, lens, esc_idx, esc_val) of
        latents of width ``w`` and depth ``c`` to the host -> (strings,
        escape pairs [K, 2], values)."""
        with profiling.wait("fetch"):
            buf, lens, esc_idx, esc_val = (t.cpu().numpy() for t in out)
        n = (w // native_format.split_factor(w, c)) * c
        pairs, vals = native_format.esc_to_pairs(esc_idx, esc_val, n)
        return torch_coder.to_bytes_list(buf, lens), pairs, vals

    def _container(self, encoded, request=None) -> bytes:
        """Copies an ``_encode_native`` result to the host and packs it;
        ``request``: the request id its span resumes (``profiling.span``)."""
        with profiling.span("container", "pack", request=request):
            return self._pack(self._native_fields(encoded))

    @torch.no_grad()
    def compress_native(self, x) -> bytes:
        """uint8 [H, W, 3] image -> native container bytes: for each latent
        one coder stream per row block plus the escape sidecar.  Not
        byte-compatible with the reference .tfci format; byte-identical to
        the JAX package's native container."""
        with profiling.span("codec", "compress_native", request=True):
            return self._container(self._encode_native(self._upload(x)))

    @torch.no_grad()
    def compress_native_many(self, images) -> list:
        """Launches every image's transforms and encodes before the first
        copy to the host; containers equal per-image compress_native."""
        with profiling.span("codec", "compress_native_many"):
            pending = []
            for x in images:
                with profiling.span("codec", "image", request=True) as req:
                    pending.append(
                        (req, self._encode_native(self._upload(x))))
            return [self._container(e, request=req) for req, e in pending]

    # -- decompress --------------------------------------------------------
    def _unpack(self, container) -> PackedTensors:
        with profiling.span("container", "parse"):
            packed = PackedTensors(container)
            if packed.model != self.MODEL_ID:
                raise ValueError(f"container is for model {packed.model!r}")
            if packed.num_tensors not in (self.num_classic_tensors,
                                          self.num_native_tensors):
                raise ValueError(
                    f"not a {self.MODEL_ID} classic or native container")
            return packed

    def _decode_latent(self, packed):
        """Launches the decodes of a classic or native container; returns
        (y_hat [1, h, w, c], sanity [streams], (H, W)) on the device
        without waiting."""
        if packed.num_tensors == self.num_classic_tensors:
            return self._decode_classic(packed)
        return self._decode_native(packed)

    def _classic_streams(self, strings):
        """A classic container's streams of one latent, uploaded -> (buf,
        lens)."""
        with profiling.span("container", "parse"):
            buf, lens = torch_coder.from_bytes_list(strings)
            with profiling.wait("upload"):
                return (torch.as_tensor(buf, device=self.device),
                        torch.as_tensor(lens, device=self.device))

    def _native_streams(self, strings, h, w, c, esc_pos, esc_val):
        """A native container's row streams of one latent [1, h, w, c] and
        their escapes, uploaded -> (k, buf, lens, esc_idx, esc_val), k the
        split factor the stream count gives; raises ValueError where they
        disagree."""
        k = native_format.split_factor_from_streams(len(strings), h)
        esc_idx = torch_coder.sidecar_flatten(
            esc_pos.reshape(-1, 2), len(strings), (w // k) * c)
        if esc_idx.shape[0] != esc_val.shape[0]:
            raise ValueError("escape positions and values disagree")
        buf, lens = torch_coder.from_bytes_list(strings)
        dev = self.device
        with profiling.wait("upload"):
            return (k, torch.as_tensor(buf, device=dev),
                    torch.as_tensor(lens, device=dev),
                    torch.as_tensor(esc_idx, device=dev),
                    torch.as_tensor(esc_val, device=dev))

    def _finish(self, x_hat, sanity, x_hw, request=None) -> np.ndarray:
        with profiling.span("codec", "finish", request=request):
            if self._y_em.decode_sanity_check:
                with profiling.wait("sanity"):
                    sane = bool(sanity.all())
                if not sane:
                    raise ValueError(
                        "Sanity check failed (corrupt bit streams).")
            with profiling.wait("fetch"):
                return x_hat[0, : x_hw[0], : x_hw[1], :].cpu().numpy()

    @torch.no_grad()
    def decompress(self, container: bytes) -> np.ndarray:
        """Classic or native container -> uint8 [H, W, 3]; raises
        ValueError on a corrupt container."""
        with profiling.span("codec", "decompress", request=True):
            y_hat, sanity, x_hw = self._decode_latent(self._unpack(container))
            return self._finish(self._synthesis_u8(y_hat), sanity, x_hw)

    @torch.no_grad()
    def decompress_native_many(self, containers) -> list:
        """Launches every container's decodes and transforms (classic or
        native) before the first copy to the host; outputs equal
        per-container decompress."""
        with profiling.span("codec", "decompress_native_many"):
            pending = []
            for c in containers:
                with profiling.span("codec", "image", request=True) as req:
                    y_hat, sanity, x_hw = self._decode_latent(
                        self._unpack(c))
                    pending.append(
                        (req, self._synthesis_u8(y_hat), sanity, x_hw))
            return [self._finish(*p, request=req) for req, *p in pending]

    @torch.no_grad()
    def reconstruct(self, x) -> np.ndarray:
        """Reconstruction without the range coder: the codec's quantized
        latent, synthesized; equals decompress(compress(x)) and
        decompress(compress_native(x)) exactly."""
        x = self._upload(x)
        return self._synthesis_u8(self._quantized_latent(x))[
            0, : x.shape[0], : x.shape[1], :].cpu().numpy()
