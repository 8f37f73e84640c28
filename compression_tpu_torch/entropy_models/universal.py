"""Universal quantization entropy models (Agustsson & Theis 2020, §3.2):
the PyTorch counterpart of compression_tpu/entropy_models/universal.py.

Quantization offsets are replaced by per-element pseudo-random dither
levels drawn from a fixed-seed generator that encoder and decoder share
(reference universal.py:30-41: ``tf.random.stateless_uniform`` with seed
(1234, 1234); ``util/philox.py`` reproduces it bit for bit), so nothing
about the dither is transmitted.  The dither level becomes an extra
leading index of the CDF table: ``num_noise_levels`` rows per prior row,
level-major (row = level * prior rows + prior row).  Both models code in
the reference format (in-stream Elias-gamma escapes) through
``codec/torch_coder.encode_streams`` / ``decode_streams``: on CUDA tensors
the hand-written kernels, K1 or K6' to encode and K3' to decode.  Bytes
equal the JAX package's and the reference's for the same call shapes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.entropy_models import continuous_base
from compression_tpu_torch.ops import math_ops
from compression_tpu_torch.util import philox

__all__ = [
    "UniversalBatchedEntropyModel",
    "UniversalIndexedEntropyModel",
]

_DITHER_KEY = (1234, 1234)


@functools.lru_cache(maxsize=64)
def _offset_indexes(shape, num_noise_levels, device):
    """The dither level of each element position, int32 ``shape`` on
    ``device``.  Drawn once per shape on the host (counter-based Philox)
    and kept on the device: the same call shape never draws again."""
    levels = philox.stateless_uniform_int32(
        shape, _DITHER_KEY, 0, num_noise_levels)
    return torch.as_tensor(levels, device=device)


def _dither(shape, num_noise_levels, device):
    shape = tuple(int(s) for s in shape)
    return _offset_indexes(shape, int(num_noise_levels), torch.device(device))


def _offset_indexes_to_offset(offset_indexes, num_noise_levels, dtype):
    return ((offset_indexes.to(dtype) + 1) / (num_noise_levels + 1) - 0.5)


def _range_coding_offsets(num_noise_levels, prior_shape, dtype):
    """Quantization offsets with a leading dither-level axis, for the table
    build: shape (num_noise_levels, 1, ...) against the prior's shape."""
    offset_indexes = torch.arange(num_noise_levels, dtype=dtype).reshape(
        (-1,) + (1,) * len(prior_shape))
    return _offset_indexes_to_offset(offset_indexes, num_noise_levels, dtype)


def _check_sanity(model, sanity):
    if model.decode_sanity_check and not bool(sanity.all()):
        raise ValueError("Sanity check failed (corrupt bit streams).")


def _streams(strings_or_buf, lengths, device):
    """(bytes uint8 [S, L], lengths int32 [S], their batch shape) on
    ``device`` from a list of bytes or a padded buffer and lengths."""
    if lengths is None:
        buf, lens = torch_coder.from_bytes_list(list(strings_or_buf))
        batch_shape = (len(lens),)
    else:
        lens = torch.as_tensor(lengths)
        batch_shape = tuple(lens.shape)
        buf = torch.as_tensor(strings_or_buf)
        buf = buf.reshape(-1, buf.shape[-1])
    return (torch.as_tensor(buf, device=device).to(torch.uint8),
            torch.as_tensor(lens, device=device).to(torch.int32).reshape(-1),
            batch_shape)


class UniversalBatchedEntropyModel(
        continuous_base.ContinuousEntropyModelBase):
    """Batched entropy model with universal (dithered) quantization.

    The tables are built from ``prior`` on the CPU; the model codes on
    ``device``: "cuda" unless the caller asks for the CPU.
    """

    def __init__(self, prior, coding_rank, compression=False,
                 expected_grads=False, tail_mass=2**-8,
                 range_coder_precision=12, num_noise_levels=15,
                 decode_sanity_check=True, laplace_tail_mass=0.0,
                 device="cuda"):
        super().__init__(coding_rank=coding_rank, compression=compression,
                         expected_grads=expected_grads, tail_mass=tail_mass,
                         laplace_tail_mass=laplace_tail_mass, device=device)
        self._prior = prior
        self._num_noise_levels = int(num_noise_levels)
        self._prior_shape = tuple(int(s) for s in prior.batch_shape)
        if self.coding_rank < len(self.prior_shape):
            raise ValueError(
                "`coding_rank` can't be smaller than prior rank.")
        self.decode_sanity_check = decode_sanity_check
        if self.compression:
            offset = _range_coding_offsets(
                self._num_noise_levels, self.prior_shape,
                self.bottleneck_dtype)
            self._init_compression(*self._build_tables(
                self.prior, range_coder_precision, offset=offset))

    @property
    def prior_shape(self):
        return self._prior_shape

    def _compute_indexes_and_offset(self, broadcast_shape, device):
        """Flat CDF row ids (int32) and dither offsets for the shape
        broadcast_shape + prior_shape."""
        prior_size = int(np.prod(self.prior_shape)) if self.prior_shape \
            else 1
        full_shape = tuple(broadcast_shape) + (prior_size,)
        offset_idx = _dither(full_shape, self._num_noise_levels, device)
        prior_idx = torch.arange(prior_size, dtype=torch.int32,
                                 device=offset_idx.device)
        indexes = offset_idx * prior_size + prior_idx
        offset = _offset_indexes_to_offset(
            offset_idx, self._num_noise_levels, self.bottleneck_dtype)
        out_shape = tuple(broadcast_shape) + self.prior_shape
        return indexes.reshape(out_shape), offset.reshape(out_shape)

    def __call__(self, bottleneck, training=False, generator=None, u=None):
        """Perturbs (training: uniform noise from ``generator`` on the
        bottleneck's device, or given as ``u``) or dither-quantizes the
        bottleneck; returns (bottleneck_perturbed, bits summed over the
        coding rank)."""
        bottleneck = torch.as_tensor(bottleneck).to(self.bottleneck_dtype)

        def log_prob_fn(bottleneck_perturbed):
            return self._log_prob(self.prior, bottleneck_perturbed)

        if training:
            log_probs, bottleneck_perturbed = math_ops.perturb_and_apply(
                log_prob_fn, bottleneck, generator=generator, u=u,
                expected_grads=self.expected_grads)
        else:
            shape = tuple(bottleneck.shape)
            coding_shape = shape[len(shape) - self.coding_rank:]
            _, offset = self._compute_indexes_and_offset(
                coding_shape[: self.coding_rank - len(self.prior_shape)],
                bottleneck.device)
            bottleneck_perturbed = torch.round(bottleneck - offset) + offset
            log_probs = log_prob_fn(bottleneck_perturbed)
        return bottleneck_perturbed, self._bits(log_probs)

    def _symbols(self, bottleneck):
        """Coder symbols and CDF rows, both int32 [S, N] on the model's
        device (one stream per batch element), and the batch shape."""
        bottleneck = torch.as_tensor(bottleneck, device=self.device).to(
            self.bottleneck_dtype)
        shape = tuple(bottleneck.shape)
        batch_rank = len(shape) - self.coding_rank
        batch_shape = shape[:batch_rank]
        indexes, offset = self._compute_indexes_and_offset(
            shape[batch_rank: len(shape) - len(self.prior_shape)],
            self.device)
        symbols = torch.round(bottleneck - offset).to(torch.int32)
        symbols = symbols - self._row_offsets()[indexes.long()]
        num_streams = int(np.prod(batch_shape)) if batch_shape else 1
        symbols = symbols.reshape(num_streams, -1)
        return (symbols, indexes.reshape(1, -1).expand(symbols.shape),
                batch_shape)

    def compress(self, bottleneck):
        """Compresses to the reference format, one stream per batch
        element.

        Returns:
          (bytes uint8 [batch..., L] zero past each length, lengths int32
           [batch...]) on the model's device.
        """
        self._check_compression()
        symbols, rows, batch_shape = self._symbols(bottleneck)
        buf, lengths = torch_coder.encode_streams(symbols, self.device_table,
                                                  rows)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape))

    def compress_to_strings(self, bottleneck):
        """Compresses to a flat list of bytes objects (one per stream)."""
        buf, lengths = self.compress(bottleneck)
        return torch_coder.to_bytes_list(
            buf.reshape(-1, buf.shape[-1]).cpu().numpy(),
            lengths.reshape(-1).cpu().numpy())

    def decompress(self, strings_or_buf, broadcast_shape, lengths=None):
        """Decodes reference-format streams to the dithered values,
        batch + broadcast_shape + prior_shape, on the model's device;
        raises ValueError when the sanity check fails."""
        self._check_compression()
        buf, lens, batch_shape = _streams(strings_or_buf, lengths,
                                          self.device)
        broadcast_shape = tuple(int(s) for s in broadcast_shape)
        indexes, offset = self._compute_indexes_and_offset(
            broadcast_shape, self.device)
        n = indexes.numel()
        idx2 = indexes.reshape(1, n).expand(lens.shape[0], n)
        symbols, sanity = torch_coder.decode_streams(
            buf, lens, n, self.device_table, idx2)
        _check_sanity(self, sanity)
        symbols = symbols + self._row_offsets()[idx2.long()]
        out_shape = batch_shape + broadcast_shape + self.prior_shape
        return symbols.reshape(out_shape).to(self.bottleneck_dtype) + offset


class UniversalIndexedEntropyModel(
        continuous_base.ContinuousEntropyModelBase):
    """Indexed entropy model with universal (dithered) quantization.

    ``indexes`` carry their index channels on the last axis; the dither
    level is prepended to them as the leading index range.  The tables
    are built on the CPU over the meshgrid of ``index_ranges``; the model
    codes on ``device``: "cuda" unless the caller asks for the CPU.
    """

    def __init__(self, prior_fn, index_ranges, parameter_fns, coding_rank,
                 compression=False, expected_grads=False, tail_mass=2**-8,
                 range_coder_precision=12, num_noise_levels=15,
                 decode_sanity_check=True, laplace_tail_mass=0.0,
                 device="cuda"):
        if coding_rank <= 0:
            raise ValueError("`coding_rank` must be larger than 0.")
        super().__init__(coding_rank=coding_rank, compression=compression,
                         expected_grads=expected_grads, tail_mass=tail_mass,
                         laplace_tail_mass=laplace_tail_mass, device=device)
        self._index_ranges = tuple(
            [int(num_noise_levels)] + [int(r) for r in index_ranges])
        self._prior_fn = prior_fn
        self._parameter_fns = dict(parameter_fns)
        self.prior_dtype = torch.float32
        self._num_noise_levels = int(num_noise_levels)
        self.decode_sanity_check = decode_sanity_check
        if self.compression:
            mesh = torch.meshgrid(
                *[torch.arange(r, dtype=torch.int32)
                  for r in self.index_ranges_without_offsets],
                indexing="ij")
            self._prior = self._make_prior(torch.stack(mesh, dim=-1))
            offset = _range_coding_offsets(
                self._num_noise_levels, self.prior.batch_shape,
                self.bottleneck_dtype)
            self._init_compression(*self._build_tables(
                self.prior, range_coder_precision, offset=offset))

    @property
    def index_ranges(self):
        return self._index_ranges

    @property
    def index_ranges_without_offsets(self):
        return self._index_ranges[1:]

    def _make_prior(self, indexes):
        indexes = torch.as_tensor(indexes).to(self.prior_dtype)
        parameters = {k: f(indexes) for k, f in self._parameter_fns.items()}
        return self._prior_fn(**parameters)

    def _prepare(self, indexes):
        """(flat CDF row ids int32, dither offsets) of an index tensor:
        the dither level prepended, clipped into the ranges, flattened."""
        indexes = torch.as_tensor(indexes, device=self.device).to(
            self.prior_dtype)
        level = _dither(indexes.shape[:-1], self._num_noise_levels,
                        self.device)
        indexes = torch.cat([level[..., None].to(indexes.dtype), indexes],
                            dim=-1)
        indexes = math_ops.lower_bound(indexes, 0)
        bounds = torch.tensor([r - 1 for r in self.index_ranges],
                              dtype=indexes.dtype, device=indexes.device)
        indexes = math_ops.upper_bound(indexes, bounds)
        strides = np.concatenate(
            [np.cumprod(np.asarray(self.index_ranges)[:0:-1])[::-1], [1]])
        # Row-major strides over the last axis, summed elementwise (CUDA
        # has no integer matmul for tensordot).
        flat = (indexes.to(torch.int32) * torch.as_tensor(
            strides.astype(np.int32), device=self.device)).sum(
                -1, dtype=torch.int32)
        offset = _offset_indexes_to_offset(
            indexes[..., 0], self._num_noise_levels, self.bottleneck_dtype)
        return flat, offset

    def __call__(self, bottleneck, indexes, training=False, generator=None,
                 u=None):
        """Perturbs (training: uniform noise from ``generator`` on the
        bottleneck's device, or given as ``u``) or dither-quantizes the
        bottleneck; the gradient reaches the indexes through the prior
        they pick.  Returns (bottleneck_perturbed, bits summed over the
        coding rank)."""
        bottleneck = torch.as_tensor(bottleneck).to(self.bottleneck_dtype)
        indexes = torch.as_tensor(indexes).to(self.prior_dtype)
        if training:

            def log_prob_fn(bottleneck_perturbed, idx):
                return self._log_prob(self._make_prior(idx),
                                      bottleneck_perturbed)

            log_probs, bottleneck_perturbed = math_ops.perturb_and_apply(
                log_prob_fn, bottleneck, indexes, generator=generator, u=u,
                expected_grads=self.expected_grads)
        else:
            offset = _offset_indexes_to_offset(
                _dither(bottleneck.shape, self._num_noise_levels,
                        bottleneck.device),
                self._num_noise_levels, self.bottleneck_dtype)
            bottleneck_perturbed = torch.round(bottleneck - offset) + offset
            log_probs = self._log_prob(self._make_prior(indexes),
                                       bottleneck_perturbed)
        return bottleneck_perturbed, self._bits(log_probs)

    def _symbols(self, bottleneck, indexes):
        """Coder symbols and CDF rows, both int32 [S, N] on the model's
        device (one stream per batch element), and the batch shape."""
        bottleneck = torch.as_tensor(bottleneck, device=self.device).to(
            self.bottleneck_dtype)
        flat, offset = self._prepare(indexes)
        batch_shape = tuple(flat.shape[: flat.ndim - self.coding_rank])
        num_streams = int(np.prod(batch_shape)) if batch_shape else 1
        symbols = torch.round(bottleneck - offset).to(torch.int32)
        symbols = symbols - self._row_offsets()[flat.long()]
        return (symbols.reshape(num_streams, -1),
                flat.reshape(num_streams, -1), batch_shape)

    def compress(self, bottleneck, indexes):
        """Compresses to the reference format with one CDF row per element
        (its dither level and indexes).

        Returns:
          (bytes uint8 [batch..., L] zero past each length, lengths int32
           [batch...]) on the model's device.
        """
        self._check_compression()
        symbols, rows, batch_shape = self._symbols(bottleneck, indexes)
        buf, lengths = torch_coder.encode_streams(symbols, self.device_table,
                                                  rows)
        return (buf.reshape(batch_shape + buf.shape[-1:]),
                lengths.reshape(batch_shape))

    def compress_to_strings(self, bottleneck, indexes):
        """Compresses to a flat list of bytes objects (one per stream)."""
        buf, lengths = self.compress(bottleneck, indexes)
        return torch_coder.to_bytes_list(
            buf.reshape(-1, buf.shape[-1]).cpu().numpy(),
            lengths.reshape(-1).cpu().numpy())

    def decompress(self, strings_or_buf, indexes, lengths=None):
        """Decodes reference-format streams with the index tensor of
        compress to the dithered values, on the model's device; raises
        ValueError when the sanity check fails."""
        self._check_compression()
        flat, offset = self._prepare(indexes)
        out_shape = tuple(flat.shape)
        batch_rank = flat.ndim - self.coding_rank
        num_streams = int(np.prod(out_shape[:batch_rank])) if batch_rank \
            else 1
        n = int(np.prod(out_shape[batch_rank:]))
        buf, lens, _ = _streams(strings_or_buf, lengths, self.device)
        idx2 = flat.reshape(num_streams, n)
        symbols, sanity = torch_coder.decode_streams(
            buf.reshape(num_streams, -1), lens.reshape(num_streams), n,
            self.device_table, idx2)
        _check_sanity(self, sanity)
        symbols = symbols + self._row_offsets()[idx2.long()]
        return symbols.reshape(out_shape).to(self.bottleneck_dtype) + offset
