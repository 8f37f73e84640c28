"""Indexed entropy models: data-dependent priors selected per element
(PyTorch counterpart of
compression_tpu/entropy_models/continuous_indexed.py).

A parameterized family of priors is sampled over a meshgrid of
``index_ranges`` at init to build one CDF row per parameter combination; at
run time an ``indexes`` tensor picks the row per element
(hyperprior-conditioned coding, Ballé et al. 2018).
``LocationScaleIndexedEntropyModel`` is the scale-table special case with
the location parameter subtracted before coding.

It covers ``__call__`` in training mode (uniform noise from a generator
on the bottleneck's device, or given as ``u``) and eval mode, ``quantize``,
the reference-format ``compress`` / ``compress_to_strings`` /
``decompress`` (in-stream Elias-gamma escapes, the .tfci format), the
sidecar pair the native container runs on, and the budgeted pair
``compress_device`` / ``decompress_device`` that copies nothing to the
host.  Every method takes
and returns tensors on the model's device.  The JAX package has each sidecar
method twice, an untraced host wrapper and a ``_device`` one that runs
inside jit; here one pair serves, under the ``_device`` names, as in
``continuous_batched``.
"""

from __future__ import annotations

import numpy as np
import torch

from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.entropy_models import continuous_base
from compression_tpu_torch.ops import math_ops
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util import profiling

__all__ = [
    "ContinuousIndexedEntropyModel",
    "LocationScaleIndexedEntropyModel",
]


class ContinuousIndexedEntropyModel(
        continuous_base.ContinuousEntropyModelBase):
    """Indexed entropy model for continuous random variables.

    Args:
      prior_fn: class or factory of the prior, called with one keyword
        argument per entry of ``parameter_fns``.
      index_ranges: the integer range of each index channel.
      parameter_fns: name -> function of the (float) indexes.
      coding_rank: innermost dimensions coded into one stream.
      channel_axis: axis of ``indexes`` that holds the index channels, or
        None for a single range without a channel axis.
      cdf, cdf_offset: carried tables (else built from the prior over the
        meshgrid of ``index_ranges``, on the CPU).
      device: where the model codes: "cuda" unless the caller asks for the
        CPU.
    """

    def __init__(self, prior_fn, index_ranges, parameter_fns, coding_rank,
                 channel_axis=-1, compression=False, expected_grads=False,
                 tail_mass=2**-8, range_coder_precision=12, cdf=None,
                 cdf_offset=None, decode_sanity_check=True,
                 laplace_tail_mass=0.0, device="cuda"):
        if not callable(prior_fn):
            raise TypeError("`prior_fn` must be a class or factory function.")
        for name, fn in parameter_fns.items():
            if not isinstance(name, str):
                raise TypeError("`parameter_fns` must have string keys.")
            if not callable(fn):
                raise TypeError(f"`parameter_fns['{name}']` must be callable.")
        super().__init__(coding_rank=coding_rank, compression=compression,
                         expected_grads=expected_grads, tail_mass=tail_mass,
                         laplace_tail_mass=laplace_tail_mass, device=device)
        self._index_ranges = tuple(int(r) for r in index_ranges)
        if not self.index_ranges:
            raise ValueError("`index_ranges` must have at least one element.")
        self._channel_axis = None if channel_axis is None \
            else int(channel_axis)
        if self.channel_axis is None and len(self.index_ranges) > 1:
            raise ValueError(
                "`channel_axis` can't be None for len(index_ranges) > 1.")
        self._prior_fn = prior_fn
        self._parameter_fns = dict(parameter_fns)
        self.prior_dtype = torch.float32
        self.decode_sanity_check = decode_sanity_check

        if self.compression:
            if cdf is None:
                if self.channel_axis is None:
                    (index_range,) = self.index_ranges
                    indexes = torch.arange(index_range, dtype=torch.int32)
                else:
                    mesh = torch.meshgrid(
                        *[torch.arange(r, dtype=torch.int32)
                          for r in self.index_ranges], indexing="ij")
                    indexes = torch.stack(mesh, dim=self.channel_axis)
                self._prior = self._make_prior(indexes)
                cdf, cdf_offset = self._build_tables(
                    self.prior, range_coder_precision)
            self._init_compression(cdf, cdf_offset)

    @property
    def index_ranges(self):
        return self._index_ranges

    @property
    def parameter_fns(self):
        return self._parameter_fns

    @property
    def prior_fn(self):
        return self._prior_fn

    @property
    def channel_axis(self):
        return self._channel_axis

    def _make_prior(self, indexes):
        indexes = indexes.to(self.prior_dtype)
        parameters = {k: f(indexes) for k, f in self.parameter_fns.items()}
        return self.prior_fn(**parameters)

    def _normalize_indexes(self, indexes):
        """Clips indexes into the valid ranges (with useful gradients)."""
        indexes = math_ops.lower_bound(indexes, 0)
        if self.channel_axis is None:
            (index_range,) = self.index_ranges
            bounds = index_range - 1
        else:
            axes = [1] * indexes.ndim
            axes[self.channel_axis] = len(self.index_ranges)
            bounds = torch.tensor(
                [r - 1 for r in self.index_ranges], dtype=indexes.dtype,
                device=indexes.device).reshape(axes)
        return math_ops.upper_bound(indexes, bounds)

    def _flatten_indexes(self, indexes):
        """Row-major strides over the index channels -> flat CDF row id."""
        indexes = indexes.to(torch.int32)
        if self.channel_axis is None:
            return indexes
        strides = np.concatenate(
            [np.cumprod(self.index_ranges[:0:-1])[::-1], [1]])
        strides = torch.as_tensor(strides.astype(np.int32),
                                  device=indexes.device)
        return torch.tensordot(indexes, strides,
                               dims=([self.channel_axis], [0]))

    def _prepare(self, indexes):
        """(flat row ids int32 [S, N], full shape, batch shape) of an index
        tensor."""
        indexes = self._normalize_indexes(
            torch.as_tensor(indexes, device=self.device).to(self.prior_dtype))
        flat = self._flatten_indexes(indexes)
        out_shape = tuple(flat.shape)
        batch_shape = out_shape[: flat.ndim - self.coding_rank]
        num_streams = int(np.prod(batch_shape)) if batch_shape else 1
        return flat.reshape(num_streams, -1), out_shape, batch_shape

    def _symbols(self, bottleneck, indexes):
        """Coder symbols and row ids, both int32 [S, N], plus the batch
        shape."""
        bottleneck = torch.as_tensor(
            bottleneck, device=self.device).to(self.bottleneck_dtype)
        idx2, _, batch_shape = self._prepare(indexes)
        symbols = torch.round(bottleneck).to(torch.int32).reshape(idx2.shape)
        return symbols - self._row_offsets()[idx2.long()], idx2, batch_shape

    def _values(self, symbols, idx2, out_shape):
        symbols = symbols + self._row_offsets()[idx2.long()]
        return symbols.reshape(out_shape).to(self.bottleneck_dtype)

    def __call__(self, bottleneck, indexes, training=False, generator=None,
                 u=None):
        """Perturbs or quantizes the bottleneck and estimates the bitrate.

        In training mode the noise comes from ``generator`` (on the
        bottleneck's device) or is given as ``u``; the gradient reaches the
        indexes through the prior they pick (``_make_prior``).  Returns
        (bottleneck_perturbed, bits summed over the coding rank).
        """
        indexes = self._normalize_indexes(indexes.to(self.prior_dtype))
        if training:

            def log_prob_fn(bottleneck_perturbed, idx):
                return self._log_prob(self._make_prior(idx),
                                      bottleneck_perturbed)

            log_probs, bottleneck_perturbed = math_ops.perturb_and_apply(
                log_prob_fn, bottleneck, indexes, generator=generator, u=u,
                expected_grads=self.expected_grads)
        else:
            bottleneck_perturbed = self.quantize(bottleneck)
            log_probs = self._log_prob(self._make_prior(indexes),
                                       bottleneck_perturbed)
        return bottleneck_perturbed, self._bits(log_probs)

    def quantize(self, bottleneck):
        return round_ops.round_st(bottleneck)

    def compress(self, bottleneck, indexes):
        """Compresses to the reference format with per-element CDF rows.

        Returns:
          (bytes uint8 [batch..., L] zero past each length, lengths int32
           [batch...]) on the model's device; byte-identical to the JAX
          package's compress.
        """
        self._check_compression()
        symbols, idx2, batch_shape = self._symbols(bottleneck, indexes)
        buf, lengths = torch_coder.encode_streams(
            symbols, self.device_table, idx2)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape))

    def compress_to_strings(self, bottleneck, indexes):
        """Compresses to a flat list of bytes objects (one per stream)."""
        buf, lengths = self.compress(bottleneck, indexes)
        with profiling.span("container", "pack"):
            with profiling.wait("fetch"):
                buf = buf.reshape(-1, buf.shape[-1]).cpu().numpy()
                lengths = lengths.reshape(-1).cpu().numpy()
            return torch_coder.to_bytes_list(buf, lengths)

    def decompress(self, strings_or_buf, indexes, lengths=None):
        """Decompresses reference-format streams with the index tensor of
        compress; raises ValueError when the sanity check fails."""
        if lengths is None:
            buf, lens = torch_coder.from_bytes_list(list(strings_or_buf))
        else:
            buf = torch.as_tensor(strings_or_buf)
            buf = buf.reshape(-1, buf.shape[-1])
            lens = torch.as_tensor(lengths).reshape(-1)
        values, sanity = self.decompress_device(
            torch.as_tensor(buf, device=self.device),
            torch.as_tensor(lens, device=self.device), indexes)
        if self.decode_sanity_check and not bool(sanity.all()):
            raise ValueError("Sanity check failed (corrupt bit streams).")
        return values

    def compress_device(self, bottleneck, indexes, max_gamma_bits=16,
                        escape_budget=64):
        """Reference-format compress with a static budget: nothing is
        copied to the host (counterpart of the JAX package's traced
        compress_device).

        Up to ``escape_budget`` escaping symbols per stream, each within
        ``+-2**max_gamma_bits`` of the table range; ``ok`` reports whether
        the data fit (if not, the bytes are not a valid stream and the
        caller takes ``compress``).

        Returns:
          (bytes uint8 [batch..., L], lengths int32 [batch...], ok bool
           scalar tensor).
        """
        self._check_compression()
        symbols, idx2, batch_shape = self._symbols(bottleneck, indexes)
        buf, lengths, ok = continuous_base.compress_budgeted(
            symbols, idx2, self.device_table, max_gamma_bits, escape_budget)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape), ok)

    def decompress_device(self, buf, byte_lens, indexes):
        """Reference-format decode without the sanity check's copy to the
        host.

        Args:
          buf: uint8 [S, W] stream bytes on the model's device (zero past
            each length).
          byte_lens: int32 [S].
          indexes: the index tensor of compress.

        Returns:
          (values float32, shaped as the flattened indexes; sanity bool
           [S]).
        """
        self._check_compression()
        idx2, out_shape, _ = self._prepare(indexes)
        symbols, sanity = torch_coder.decode_streams(
            buf.to(torch.uint8), byte_lens.to(torch.int32), idx2.shape[1],
            self.device_table, idx2)
        return self._values(symbols, idx2, out_shape), sanity

    def compress_sidecar_device(self, bottleneck, indexes):
        """Sidecar compress: escaping values are coded in-stream only as
        the escape marker and come back as a flat (position, value) list.
        Byte-identical streams to the JAX package's compress_sidecar.

        Returns:
          (bytes uint8 [batch..., L], lengths int32 [batch...], esc_idx
           int64 [K] flat positions (ascending), esc_val int32 [K]).
        """
        self._check_compression()
        symbols, idx2, batch_shape = self._symbols(bottleneck, indexes)
        table = self.device_table
        if table.any_overflow:
            rows = idx2.long()
            escape = table.overflow[rows] & (
                (symbols < 0) | (symbols >= table.length[rows] - 2))
            esc_idx, esc_val = torch_coder.sidecar_extract(symbols, escape)
        else:
            esc_idx = torch.zeros(0, dtype=torch.int64, device=self.device)
            esc_val = torch.zeros(0, dtype=torch.int32, device=self.device)
        out_size = torch_coder.stream_out_size(symbols.shape[1])
        buf, lengths = torch_coder.encode_dispatch(
            symbols, table, out_size, idx2)
        return (buf.reshape(batch_shape + (out_size,)),
                lengths.reshape(batch_shape), esc_idx, esc_val)

    def decompress_sidecar_device(self, buf, byte_lens, indexes, esc_idx,
                                  esc_val):
        """Sidecar decompress (see compress_sidecar_device); returns
        (values, sanity bool [S])."""
        self._check_compression()
        idx2, out_shape, _ = self._prepare(indexes)
        symbols, sanity = torch_coder.decode_dispatch(
            buf, byte_lens, idx2.shape[1], self.device_table, idx2,
            in_stream_gamma=False)
        symbols = torch_coder.sidecar_apply(symbols, esc_idx, esc_val)
        return self._values(symbols, idx2, out_shape), sanity


class LocationScaleIndexedEntropyModel(ContinuousIndexedEntropyModel):
    """Indexed entropy model over a table of scales, with loc shifted out."""

    def __init__(self, prior_fn, num_scales, scale_fn, coding_rank,
                 compression=False, expected_grads=False, tail_mass=2**-8,
                 range_coder_precision=12, cdf=None, cdf_offset=None,
                 decode_sanity_check=True, laplace_tail_mass=0.0,
                 device="cuda"):
        super().__init__(
            prior_fn=prior_fn, index_ranges=(int(num_scales),),
            parameter_fns=dict(loc=lambda _: 0.0, scale=scale_fn),
            coding_rank=coding_rank, channel_axis=None,
            compression=compression, expected_grads=expected_grads,
            tail_mass=tail_mass,
            range_coder_precision=range_coder_precision, cdf=cdf,
            cdf_offset=cdf_offset, decode_sanity_check=decode_sanity_check,
            laplace_tail_mass=laplace_tail_mass, device=device)

    def __call__(self, bottleneck, scale_indexes, loc=None, training=False,
                 generator=None, u=None):
        if loc is None:
            return super().__call__(bottleneck, scale_indexes,
                                    training=training, generator=generator,
                                    u=u)
        bottleneck, bits = super().__call__(
            bottleneck - loc, scale_indexes, training=training,
            generator=generator, u=u)
        return bottleneck + loc, bits

    def quantize(self, bottleneck, loc=None):
        return round_ops.round_st(bottleneck, loc)

    @staticmethod
    def _shift(bottleneck, loc):
        return bottleneck if loc is None else bottleneck - loc

    @staticmethod
    def _unshift(result, loc):
        values, *rest = result if isinstance(result, tuple) else (result,)
        if loc is not None:
            values = values + loc
        return (values, *rest) if rest else values

    def compress(self, bottleneck, scale_indexes, loc=None):
        return super().compress(self._shift(bottleneck, loc), scale_indexes)

    def compress_to_strings(self, bottleneck, scale_indexes, loc=None):
        return super().compress_to_strings(
            self._shift(bottleneck, loc), scale_indexes)

    def decompress(self, strings_or_buf, scale_indexes, loc=None,
                   lengths=None):
        return self._unshift(super().decompress(
            strings_or_buf, scale_indexes, lengths=lengths), loc)

    def compress_device(self, bottleneck, scale_indexes, loc=None,
                        max_gamma_bits=16, escape_budget=64):
        return super().compress_device(
            self._shift(bottleneck, loc), scale_indexes,
            max_gamma_bits=max_gamma_bits, escape_budget=escape_budget)

    def decompress_device(self, buf, byte_lens, scale_indexes, loc=None):
        return self._unshift(super().decompress_device(
            buf, byte_lens, scale_indexes), loc)

    def compress_sidecar_device(self, bottleneck, scale_indexes, loc=None):
        return super().compress_sidecar_device(
            self._shift(bottleneck, loc), scale_indexes)

    def decompress_sidecar_device(self, buf, byte_lens, scale_indexes,
                                  esc_idx, esc_val, loc=None):
        return self._unshift(super().decompress_sidecar_device(
            buf, byte_lens, scale_indexes, esc_idx, esc_val), loc)
