"""Multi-stream entropy coding API (host reference path).

The unit of parallelism is the *stream*: a batch of independent range-coder
streams, one per coding unit.  This mirrors the stateful coder ops of the
reference (cc/kernels/range_coder_kernels.cc:166-479) where the handle shape
determines the number of streams, but is a pure function: symbols in, bytes
out.

Two symbol→CDF-row addressing modes:

* channel mode (index=None): element j of every stream uses CDF row
  ``j % num_rows`` (reference: EntropyEncodeChannel, range_coder_kernels.cc:
  253-257).
* indexed mode: an int32 index array of the same shape as the values picks
  the CDF row per element (EntropyEncodeIndex).

This module runs on the host in plain Python/NumPy: it is the semantic
oracle that ``codec/host.py`` (the C coder) and the CUDA kernels' plain
versions are held to.  This package's own copy of
``compression_tpu/codec/stream.py``, on the port's ``reference`` and
``tables``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from compression_tpu_torch.codec import reference
from compression_tpu_torch.codec import tables


def encode_streams(
    values: np.ndarray,
    table: Union[tables.CdfTable, np.ndarray],
    index: Optional[np.ndarray] = None,
) -> list[bytes]:
    """Encodes ``values`` [num_streams, num_elements] into one bytes/stream."""
    if not isinstance(table, tables.CdfTable):
        table = tables.parse_ragged_cdf(table)
    values = np.asarray(values, np.int64)
    if values.ndim != 2:
        raise ValueError("values must be [num_streams, num_elements]")
    num_streams, num_elements = values.shape
    if index is not None:
        index = np.asarray(index, np.int64)
        if index.shape != values.shape:
            raise ValueError("index shape must match values shape")

    out = []
    for s in range(num_streams):
        enc = reference.RangeEncoder()
        sink = bytearray()
        for j in range(num_elements):
            row = int(index[s, j]) if index is not None else j % table.num_rows
            if not 0 <= row < table.num_rows:
                raise ValueError(f"index {row} out of range [0, {table.num_rows})")
            length = int(table.length[row])
            cdf = table.cdf[row, :length]
            prec = int(table.precision[row])
            val = int(values[s, j])
            if table.overflow[row]:
                reference.overflow_encode(enc, sink, cdf, prec, val)
            else:
                if not 0 <= val < length - 1:
                    raise ValueError(
                        f"value {val} out of range [0, {length - 1})")
                enc.encode(int(cdf[val]), int(cdf[val + 1]), prec, sink)
        enc.finalize(sink)
        out.append(bytes(sink))
    return out


def decode_streams(
    strings: Sequence[bytes],
    num_elements: int,
    table: Union[tables.CdfTable, np.ndarray],
    index: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decodes each stream back to ``num_elements`` int32 symbols.

    Returns (values [num_streams, num_elements], sanity [num_streams]).
    """
    if not isinstance(table, tables.CdfTable):
        table = tables.parse_ragged_cdf(table)
    num_streams = len(strings)
    if index is not None:
        index = np.asarray(index, np.int64)
        if index.shape != (num_streams, num_elements):
            raise ValueError("index shape must be [num_streams, num_elements]")

    values = np.zeros((num_streams, num_elements), np.int32)
    sanity = np.zeros(num_streams, bool)
    for s in range(num_streams):
        dec = reference.RangeDecoder(strings[s])
        for j in range(num_elements):
            row = int(index[s, j]) if index is not None else j % table.num_rows
            length = int(table.length[row])
            cdf = table.cdf[row, :length]
            prec = int(table.precision[row])
            if table.overflow[row]:
                values[s, j] = reference.overflow_decode(dec, cdf, prec)
            else:
                values[s, j] = dec.decode(cdf, prec)
        sanity[s] = dec.finalize()
    return values, sanity
