"""Batched entropy model for continuous random variables (PyTorch
counterpart of compression_tpu/entropy_models/continuous_batched.py).

Data-independent prior, one CDF row per prior batch element, innermost
``coding_rank`` dimensions coded into one stream each.  It covers
``__call__`` in training mode (additive uniform noise, drawn from a
generator on the bottleneck's device or given as ``u``) and eval mode,
``quantize``, the reference-format ``compress`` / ``compress_to_strings``
/ ``decompress`` (in-stream Elias-gamma escapes, the .tfci format), the
sidecar pair ``compress_sidecar_device`` / ``decompress_sidecar_device``
the native container runs on, and the budgeted pair ``compress_device`` /
``decompress_device`` that copies nothing to the host.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.entropy_models import continuous_base
from compression_tpu_torch.ops import math_ops
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util import profiling
from compression_tpu_torch.util.device import resolve_device

__all__ = ["ContinuousBatchedEntropyModel"]


class ContinuousBatchedEntropyModel(
        continuous_base.ContinuousEntropyModelBase):
    """Batched entropy model: shared prior, data-independent CDF rows.

    Either ``prior`` (tables are built from it, on the CPU) or
    ``prior_shape`` with carried ``cdf`` / ``cdf_offset`` (and the
    ``quantization_offset`` they were built with) must be given.  The model
    codes on ``device``: "cuda" unless the caller asks for the CPU.
    """

    def __init__(self, prior=None, coding_rank=None, compression=False,
                 expected_grads=False, tail_mass=2**-8,
                 range_coder_precision=12,
                 prior_shape=None, cdf=None, cdf_offset=None,
                 offset_heuristic=True, quantization_offset=None,
                 decode_sanity_check=True, laplace_tail_mass=0.0,
                 device="cuda"):
        if (prior is None) == (prior_shape is None):
            raise ValueError("Either `prior` or `prior_shape` must be provided.")
        if (prior is None) == (cdf is None):
            raise ValueError("Must provide exactly one of `prior` or `cdf`.")
        if not compression and cdf is not None:
            raise ValueError("CDFs can't be provided with `compression=False`")
        super().__init__(coding_rank=coding_rank, compression=compression,
                         expected_grads=expected_grads, tail_mass=tail_mass,
                         laplace_tail_mass=laplace_tail_mass, device=device)
        self._prior = prior
        self._offset_heuristic = bool(offset_heuristic)
        self._prior_shape = tuple(
            int(s) for s in
            (prior_shape if prior is None else prior.batch_shape))
        if self.coding_rank < len(self.prior_shape):
            raise ValueError("`coding_rank` can't be smaller than prior rank.")
        self.decode_sanity_check = decode_sanity_check

        if quantization_offset is None and self._offset_heuristic \
                and self.compression and prior is not None:
            quantization_offset = helpers.quantization_offset(prior)
            if bool(torch.all(quantization_offset == 0.0)):
                quantization_offset = None
            else:
                quantization_offset = quantization_offset.expand(
                    self.prior_shape)
        self._quantization_offset = None if quantization_offset is None \
            else torch.tensor(np.asarray(quantization_offset),
                              dtype=self.bottleneck_dtype)

        if self.compression:
            if cdf is None:
                cdf, cdf_offset = self._build_tables(
                    prior, range_coder_precision,
                    offset=self._quantization_offset)
            self._init_compression(cdf, cdf_offset)
        self._offset_dev = None if self._quantization_offset is None else \
            self._quantization_offset.to(self.device)

    @property
    def prior_shape(self):
        return self._prior_shape

    def to(self, device):
        """This model coding on ``device``: itself when it codes there
        already, else a shallow copy that shares the host tables and builds
        its device table there at first use."""
        device = resolve_device(device)
        if device == self.device:
            return self
        clone = copy.copy(self)
        clone.device = device
        clone._device_table = None
        clone._row_offset = None
        if self._offset_dev is not None:
            clone._offset_dev = self._offset_dev.to(device)
        return clone

    @property
    def quantization_offset(self):
        """Offset on the model's device (None when there is none).  A model
        without tables takes it from its prior, on the prior's device, at
        each use when the offset heuristic is on (as the JAX package's
        does)."""
        if self._offset_dev is None and self._offset_heuristic \
                and not self.compression:
            return helpers.quantization_offset(self.prior)
        return self._offset_dev

    def __call__(self, bottleneck, training=False, generator=None, u=None):
        """Perturbs or quantizes the bottleneck and estimates the bitrate.

        Args:
          bottleneck: data to compress; innermost dims broadcastable to
            prior_shape, at least coding_rank dims.
          training: True gives the differentiable noisy upper bound
            (``perturb_and_apply`` over the prior's log_prob); False the
            Shannon information of the quantized tensor.
          generator: ``torch.Generator`` on the bottleneck's device that
            draws the training noise.
          u: the training noise itself, U(-.5, .5) of the bottleneck's
            shape (instead of ``generator``).

        Returns:
          (bottleneck_perturbed, bits); bits sums over the coding_rank
          innermost dimensions.
        """
        def log_prob_fn(bottleneck_perturbed):
            return self._log_prob(self.prior, bottleneck_perturbed)

        if training:
            log_probs, bottleneck_perturbed = math_ops.perturb_and_apply(
                log_prob_fn, bottleneck, generator=generator, u=u,
                expected_grads=self.expected_grads)
        else:
            bottleneck_perturbed = self.quantize(bottleneck)
            log_probs = log_prob_fn(bottleneck_perturbed)
        return bottleneck_perturbed, self._bits(log_probs)

    def quantize(self, bottleneck):
        """Rounds to integers shifted by the quantization offset;
        straight-through gradient."""
        return round_ops.round_st(bottleneck, self.quantization_offset)

    def _symbols_from_bottleneck(self, bottleneck):
        """[S, N] int32 coder symbols; element j uses CDF row j % rows."""
        batch_rank = bottleneck.ndim - self.coding_rank
        batch_shape = tuple(bottleneck.shape[:batch_rank])
        offset = self.quantization_offset
        if offset is not None:
            bottleneck = bottleneck - offset
        symbols = torch.round(bottleneck).to(torch.int32)
        symbols = symbols.reshape(int(np.prod(batch_shape)), -1)
        num_rows = int(self.cdf_offset.shape[0])
        row_ids = torch.arange(symbols.shape[1], device=self.device) % num_rows
        symbols = symbols - self._row_offsets()[row_ids][None, :]
        return symbols, batch_shape, row_ids

    def compress(self, bottleneck):
        """Compresses to the reference format on the model's device.

        The leading (batch) dims of ``bottleneck`` become one stream each;
        escapes are coded in-stream (Elias gamma).  Byte-identical to the
        JAX package's compress.

        Returns:
          (bytes uint8 [batch..., L] zero past each length, lengths int32
           [batch...]), on the model's device.
        """
        self._check_compression()
        symbols, batch_shape, _ = self._symbols_from_bottleneck(
            torch.as_tensor(bottleneck, dtype=self.bottleneck_dtype,
                            device=self.device))
        buf, lengths = torch_coder.encode_streams(symbols, self.device_table)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape))

    def compress_to_strings(self, bottleneck):
        """Compresses to a flat list of bytes objects (one per stream)."""
        buf, lengths = self.compress(bottleneck)
        with profiling.span("container", "pack"):
            with profiling.wait("fetch"):
                buf = buf.reshape(-1, buf.shape[-1]).cpu().numpy()
                lengths = lengths.reshape(-1).cpu().numpy()
            return torch_coder.to_bytes_list(buf, lengths)

    def decompress(self, strings_or_buf, broadcast_shape, lengths=None):
        """Decompresses reference-format streams to the quantized
        bottleneck; raises ValueError when the sanity check fails (and
        ``decode_sanity_check`` is set).

        Args:
          strings_or_buf: list of bytes, or a padded uint8 buffer [batch...,
            L] (numpy or torch) with ``lengths`` [batch...].
          broadcast_shape: shape between the batch dims and prior_shape.

        Returns:
          float32 tensor batch + broadcast_shape + prior_shape on the
          model's device.
        """
        if lengths is None:
            buf, lens = torch_coder.from_bytes_list(list(strings_or_buf))
            batch_shape = tuple(lens.shape)
        else:
            buf = torch.as_tensor(strings_or_buf)
            lens = torch.as_tensor(lengths)
            batch_shape = tuple(lens.shape)
            buf = buf.reshape(-1, buf.shape[-1])
        outputs, sanity = self.decompress_device(
            torch.as_tensor(buf, device=self.device),
            torch.as_tensor(lens, device=self.device).reshape(-1),
            broadcast_shape)
        if self.decode_sanity_check and not bool(sanity.all()):
            raise ValueError("Sanity check failed (corrupt bit streams).")
        return outputs.reshape(batch_shape + tuple(outputs.shape[1:]))

    def compress_device(self, bottleneck, max_gamma_bits=16,
                        escape_budget=64):
        """Reference-format compress with a static budget: nothing is
        copied to the host (counterpart of the JAX package's traced
        compress_device).

        The micro-op expansion reserves ``2 * max_gamma_bits + 3`` slots
        for every symbol and ``escape_budget`` escapes per stream; ``ok``
        reports whether the data fit (if not, the bytes are not a valid
        stream and the caller takes ``compress``, which sizes its buffer
        from the data).

        Returns:
          (bytes uint8 [batch..., L], lengths int32 [batch...], ok bool
           scalar tensor), on the model's device.
        """
        self._check_compression()
        symbols, batch_shape, row_ids = self._symbols_from_bottleneck(
            torch.as_tensor(bottleneck, dtype=self.bottleneck_dtype,
                            device=self.device))
        indexes = row_ids.to(torch.int32)[None, :].expand(
            symbols.shape).contiguous()
        buf, lengths, ok = continuous_base.compress_budgeted(
            symbols, indexes, self.device_table, max_gamma_bits,
            escape_budget)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape), ok)

    def decompress_device(self, buf, byte_lens, broadcast_shape):
        """Reference-format decode without the sanity check's copy to the
        host.

        Args:
          buf: uint8 [S, W] stream bytes on the model's device (zero past
            each length).
          byte_lens: int32 [S].
          broadcast_shape: shape between the stream and prior dims.

        Returns:
          (outputs [S, *broadcast, *prior_shape] float32, sanity bool [S]).
        """
        self._check_compression()
        broadcast_shape = tuple(int(s) for s in broadcast_shape)
        n = int(np.prod(broadcast_shape)) * int(np.prod(self.prior_shape))
        symbols, sanity = torch_coder.decode_streams(
            buf.to(torch.uint8), byte_lens.to(torch.int32), n,
            self.device_table)
        return self._dequantize(symbols, broadcast_shape), sanity

    def _dequantize(self, symbols, broadcast_shape):
        """Decoded symbols [S, N] -> [S, *broadcast, *prior_shape] float."""
        num_rows = int(self.cdf_offset.shape[0])
        row_ids = torch.arange(symbols.shape[1], device=self.device) % num_rows
        symbols = symbols + self._row_offsets()[row_ids][None]
        outputs = symbols.reshape(
            (symbols.shape[0],) + broadcast_shape + self.prior_shape).to(
                self.bottleneck_dtype)
        offset = self.quantization_offset
        if offset is not None:
            outputs = outputs + offset
        return outputs

    def compress_sidecar_device(self, bottleneck):
        """Sidecar compress on the model's device.

        Escaping values are coded in-stream only as the escape marker and
        come back as a flat (position, value) list.  Byte-identical streams
        to the JAX package's compress_sidecar(_device).

        Returns:
          (bytes uint8 [batch..., L], lengths int32 [batch...], esc_idx
           int64 [K] flat positions (ascending), esc_val int32 [K]).
        """
        self._check_compression()
        symbols, batch_shape, row_ids = self._symbols_from_bottleneck(
            bottleneck.to(self.bottleneck_dtype))
        num_streams, n = symbols.shape
        indexes = row_ids.to(torch.int32)[None, :].expand(num_streams, n)
        table = self.device_table
        if table.any_overflow:
            esc_row = table.overflow[row_ids]
            marker = table.length[row_ids] - 2
            escape = esc_row[None, :] & (
                (symbols < 0) | (symbols >= marker[None, :]))
            esc_idx, esc_val = torch_coder.sidecar_extract(symbols, escape)
        else:
            esc_idx = torch.zeros(0, dtype=torch.int64, device=self.device)
            esc_val = torch.zeros(0, dtype=torch.int32, device=self.device)
        out_size = torch_coder.stream_out_size(n)
        buf, lengths = torch_coder.encode_dispatch(
            symbols, table, out_size, indexes)
        return (buf.reshape(batch_shape + (out_size,)),
                lengths.reshape(batch_shape), esc_idx, esc_val)

    def decompress_sidecar_device(self, buf, byte_lens, broadcast_shape,
                                  esc_idx, esc_val):
        """Sidecar decompress on the model's device.

        Args:
          buf: uint8 [S, W] stream bytes (zero past each length).
          byte_lens: int32 [S].
          broadcast_shape: shape between the stream and prior dims.
          esc_idx / esc_val: flat escape positions and values.

        Returns:
          (outputs [S, *broadcast, *prior_shape] float32, sanity bool [S]).
        """
        self._check_compression()
        broadcast_shape = tuple(int(s) for s in broadcast_shape)
        num_rows = int(self.cdf_offset.shape[0])
        n = int(np.prod(broadcast_shape)) * int(np.prod(self.prior_shape))
        row_ids = torch.arange(n, device=self.device) % num_rows
        indexes = row_ids.to(torch.int32)[None, :].expand(buf.shape[0], n)
        symbols, sanity = torch_coder.decode_dispatch(
            buf, byte_lens, n, self.device_table, indexes,
            in_stream_gamma=False)
        symbols = torch_coder.sidecar_apply(symbols, esc_idx, esc_val)
        return self._dequantize(symbols, broadcast_shape), sanity

    def get_config(self):
        config = super().get_config()
        config.update(
            prior_shape=self.prior_shape,
            offset_heuristic=self._offset_heuristic,
            quantization_offset=self._quantization_offset is not None)
        return config

    def get_weights(self):
        weights = super().get_weights()
        if self._quantization_offset is not None:
            weights.append(self._quantization_offset.numpy())
        return weights
