"""Legacy (deprecated in the reference) range coding ops (PyTorch port's
copy of compression_tpu/codec/legacy.py).

Counterparts of the reference's cc/kernels/range_coding_kernels.cc
(RangeEncode/RangeDecode: one stream over the whole tensor, CDF broadcast
against the data shape) and unbounded_index_range_coding_kernels.cc
(UnboundedIndexRange{Encode,Decode}: per-symbol CDF row selection with an
offset map and a base-2**overflow_width variable-length escape code).

These exist for API completeness and for decoding old bitstreams; they are
host code over the bit-exact reference coder (codec/reference.py), numpy in
and bytes out.  The models code through ``torch_coder`` and its kernels.
"""

from __future__ import annotations

import numpy as np

from compression_tpu_torch.codec import reference

__all__ = [
    "range_encode",
    "range_decode",
    "unbounded_index_range_encode",
    "unbounded_index_range_decode",
]


def _validate_cdf_rows(rows, precision, context):
    """debug_level>=1 analog of the reference's CDF validation
    (range_coding_kernels.cc:194-196): rows must start at 0, be
    monotonically nondecreasing, and end at most at 2**precision."""
    rows = np.asarray(rows)
    if rows.shape[-1] < 2:
        raise ValueError(f"{context}: CDF rows need at least 2 entries")
    if (rows[..., 0] != 0).any():
        raise ValueError(f"{context}: CDF rows must start at 0")
    if (np.diff(rows, axis=-1) < 0).any():
        raise ValueError(f"{context}: CDF rows must be nondecreasing")
    if (rows[..., -1] > (1 << precision)).any():
        raise ValueError(
            f"{context}: CDF rows exceed 2**precision = {1 << precision}")


def _broadcast_row_indexes(data_shape, cdf_shape):
    """Row-major flat row index of the broadcast CDF row per data element."""
    bshape = cdf_shape[:-1]
    if len(bshape) != len(data_shape):
        raise ValueError(
            f"cdf shape {cdf_shape} does not broadcast against data shape "
            f"{data_shape}")
    for b, d in zip(bshape, data_shape):
        if b != 1 and b != d:
            raise ValueError(
                f"cdf shape {cdf_shape} does not broadcast against data "
                f"shape {data_shape}")
    idx = np.arange(int(np.prod(bshape))).reshape(bshape)
    return np.broadcast_to(idx, data_shape).ravel()


def range_encode(data, cdf, precision: int, debug_level: int = 1) -> bytes:
    """Encodes an int tensor into one string (legacy RangeEncode).

    cdf: int array of shape broadcastable to data.shape + (m+1,), with
    cdf[..., 0] == 0 and cdf[..., -1] <= 2**precision.
    """
    data = np.asarray(data, np.int64)
    cdf = np.asarray(cdf, np.int64)
    rows = cdf.reshape(-1, cdf.shape[-1])
    if debug_level >= 1:
        _validate_cdf_rows(rows, precision, "range_encode")
    row_idx = _broadcast_row_indexes(data.shape, cdf.shape)
    flat = data.ravel()
    enc = reference.RangeEncoder()
    sink = bytearray()
    for v, r in zip(flat, row_idx):
        row = rows[r]
        if not 0 <= v < len(row) - 1:
            raise ValueError(f"data value {v} out of range")
        enc.encode(int(row[v]), int(row[v + 1]), precision, sink)
    enc.finalize(sink)
    return bytes(sink)


def range_decode(encoded: bytes, shape, cdf, precision: int,
                 debug_level: int = 1) -> np.ndarray:
    """Inverse of range_encode; returns int16 per the reference op."""
    shape = tuple(int(s) for s in shape)
    cdf = np.asarray(cdf, np.int64)
    rows = cdf.reshape(-1, cdf.shape[-1])
    if debug_level >= 1:
        _validate_cdf_rows(rows, precision, "range_decode")
    row_idx = _broadcast_row_indexes(shape, cdf.shape)
    dec = reference.RangeDecoder(encoded)
    out = np.zeros(int(np.prod(shape)), np.int16)
    for i, r in enumerate(row_idx):
        out[i] = dec.decode(rows[r], precision)
    return out.reshape(shape)


def unbounded_index_range_encode(data, index, cdf, cdf_size, offset,
                                 precision: int,
                                 overflow_width: int,
                                 debug_level: int = 1) -> bytes:
    """Encodes with per-symbol CDF rows and an unbounded escape code.

    Matches unbounded_index_range_coding_kernels.cc:185-249: values are
    shifted by offset[row]; out-of-range values map to the escape symbol
    (max_value = cdf_size[row] - 2) and their magnitude is coded in
    base-2**overflow_width digit groups.
    """
    data = np.asarray(data, np.int64).ravel()
    index = np.asarray(index, np.int64).ravel()
    cdf = np.asarray(cdf, np.int64)
    cdf_size = np.asarray(cdf_size, np.int64)
    offset = np.asarray(offset, np.int64)
    max_overflow = (1 << overflow_width) - 1
    if debug_level >= 1:
        for r in range(cdf.shape[0]):
            _validate_cdf_rows(cdf[r][: int(cdf_size[r])], precision,
                               "unbounded_index_range_encode")
        if (index < 0).any() or (index >= cdf.shape[0]).any():
            raise ValueError(
                "unbounded_index_range_encode: index out of range")

    enc = reference.RangeEncoder()
    sink = bytearray()
    for v, r in zip(data, index):
        max_value = int(cdf_size[r]) - 2
        value = int(v) - int(offset[r])
        overflow = 0
        if value < 0:
            overflow = -2 * value - 1
            value = max_value
        elif value >= max_value:
            overflow = 2 * (value - max_value)
            value = max_value
        row = cdf[r]
        enc.encode(int(row[value]), int(row[value + 1]), precision, sink)
        if value == max_value:
            widths = 0
            while overflow >> (widths * overflow_width) != 0:
                widths += 1
            val = widths
            while val >= max_overflow:
                enc.encode(max_overflow, max_overflow + 1, overflow_width,
                           sink)
                val -= max_overflow
            enc.encode(val, val + 1, overflow_width, sink)
            for j in range(widths):
                digit = (overflow >> (j * overflow_width)) & max_overflow
                enc.encode(digit, digit + 1, overflow_width, sink)
    enc.finalize(sink)
    return bytes(sink)


def unbounded_index_range_decode(encoded: bytes, index, cdf, cdf_size,
                                 offset, precision: int,
                                 overflow_width: int,
                                 debug_level: int = 1) -> np.ndarray:
    """Inverse of unbounded_index_range_encode."""
    index = np.asarray(index, np.int64)
    out_shape = index.shape
    index = index.ravel()
    cdf = np.asarray(cdf, np.int64)
    cdf_size = np.asarray(cdf_size, np.int64)
    offset = np.asarray(offset, np.int64)
    max_overflow = (1 << overflow_width) - 1
    overflow_cdf = np.arange(max_overflow + 2, dtype=np.int64)
    if debug_level >= 1:
        for r in range(cdf.shape[0]):
            _validate_cdf_rows(cdf[r][: int(cdf_size[r])], precision,
                               "unbounded_index_range_decode")
        if (index < 0).any() or (index >= cdf.shape[0]).any():
            raise ValueError(
                "unbounded_index_range_decode: index out of range")

    dec = reference.RangeDecoder(encoded)
    out = np.zeros(index.size, np.int32)
    for i, r in enumerate(index):
        max_value = int(cdf_size[r]) - 2
        row = cdf[r][: int(cdf_size[r])]
        value = dec.decode(row, precision)
        if value == max_value:
            widths = 0
            while True:
                digit = dec.decode(overflow_cdf, overflow_width)
                widths += digit
                if digit != max_overflow:
                    break
            overflow = 0
            for j in range(widths):
                digit = dec.decode(overflow_cdf, overflow_width)
                overflow |= digit << (j * overflow_width)
            if overflow & 1:
                value = -(overflow + 1) // 2
            else:
                value = overflow // 2 + max_value
        out[i] = value + int(offset[r])
    return out.reshape(out_shape)
