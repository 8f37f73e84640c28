"""Native host multi-stream range codec (C++, std::thread fan-out).

This package's own copy of ``compression_tpu/codec/host.py``: numpy in and
out, over the C coder in ``native/range_coder.cc``, which is built into
``_build/`` at first use.  Bit-exact with the Python oracle in
``codec/stream.py`` and therefore with the reference coder
(golden-pinned), and with the reference-format CUDA wrappers
``torch_coder.encode_streams`` / ``decode_streams``.

It is an entry point of its own: the host path for container tooling and
decode on a machine without a card, and the yardstick the CUDA kernels are
timed against.  Nothing routes tensors here.  Unlike the JAX package, a
library that cannot be built raises: there is no fallback to the oracle.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Union

import numpy as np

from compression_tpu_torch import native
from compression_tpu_torch.codec import tables

__all__ = ["encode_streams", "decode_streams", "available"]


def available() -> bool:
    """True when the native library builds and loads."""
    try:
        native.get_range_coder_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_table(table) -> tables.CdfTable:
    if isinstance(table, tables.CdfTable):
        return table
    return tables.parse_ragged_cdf(table)


def _i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _num_threads(num_streams: int) -> int:
    return max(1, min(os.cpu_count() or 1, num_streams))


def _table_arrays(t: tables.CdfTable):
    return (np.ascontiguousarray(t.cdf, np.int32),
            np.ascontiguousarray(t.length, np.int32),
            np.ascontiguousarray(t.precision, np.int32),
            np.ascontiguousarray(t.overflow, np.uint8))


def encode_streams(
    values: np.ndarray,
    table: Union[tables.CdfTable, np.ndarray],
    index: Optional[np.ndarray] = None,
    num_threads: Optional[int] = None,
) -> list[bytes]:
    """Encodes ``values`` [num_streams, num_elements] into one bytes/stream.

    Same semantics as `stream.encode_streams` (channel mode when ``index``
    is None: element j uses row j % num_rows), multithreaded native
    implementation; by default one thread per stream up to the host's
    cores.
    """
    lib = native.get_range_coder_lib()
    t = _as_table(table)
    values = np.ascontiguousarray(values, np.int32)
    if values.ndim != 2:
        raise ValueError("values must be [num_streams, num_elements]")
    num_streams, n = values.shape
    if num_streams == 0:
        return []
    idx_p = None
    if index is not None:
        index = np.ascontiguousarray(index, np.int32)
        if index.shape != values.shape:
            raise ValueError("index shape must match values shape")
        if index.size and (index.min() < 0 or index.max() >= t.num_rows):
            raise ValueError("index out of range")
        idx_p = _i32p(index)

    # Worst-case bytes/stream: 2 per micro-op + 2 finalize.  Escapes expand
    # to 2*ceil(log2(g))+3 ops; bound with the data (only when the table
    # has overflow rows -- the budgeting pass costs more than the encode
    # itself at large sizes otherwise).
    ovf_np = np.asarray(t.overflow)
    if not ovf_np.any():
        out_stride = 2 * max(n, 1) + 4
    else:
        len_np = np.asarray(t.length, np.int64)
        rows = (index if index is not None
                else np.broadcast_to(np.arange(n) % t.num_rows, values.shape))
        mv = len_np[rows] - 2
        v64 = values.astype(np.int64)
        esc = ovf_np[rows] & ((v64 < 0) | (v64 >= mv))
        gamma = np.where(v64 < 0, -v64, v64 - mv + 1)
        nbits = np.floor(np.log2(np.maximum(gamma, 1))).astype(np.int64)
        ops = np.where(esc, 3 + 2 * nbits, 1).sum(axis=1).max() if n else 0
        out_stride = int(2 * max(int(ops), 1) + 4)

    cdf, length, precision, overflow = _table_arrays(t)
    out = np.zeros((num_streams, out_stride), np.uint8)
    out_lengths = np.zeros(num_streams, np.int32)
    rc = lib.ctpu_encode_streams(
        _i32p(values), idx_p, num_streams, n,
        _i32p(cdf), _i32p(length), _i32p(precision), _u8p(overflow),
        t.num_rows, t.cdf.shape[1],
        _u8p(out), out_stride, _i32p(out_lengths),
        num_threads or _num_threads(num_streams))
    if rc == -2:
        raise ValueError("value out of range for a bounded CDF row")
    if rc != 0:
        raise RuntimeError(f"native encode failed ({rc})")
    return [bytes(out[s, : out_lengths[s]]) for s in range(num_streams)]


def decode_streams(
    strings: Sequence[bytes],
    num_elements: int,
    table: Union[tables.CdfTable, np.ndarray],
    index: Optional[np.ndarray] = None,
    num_threads: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decodes each stream back to ``num_elements`` int32 symbols.

    Returns (values [num_streams, num_elements], sanity bool [num_streams]).
    """
    lib = native.get_range_coder_lib()
    t = _as_table(table)
    num_streams = len(strings)
    if num_streams == 0:
        return (np.zeros((0, num_elements), np.int32), np.zeros(0, bool))
    idx_p = None
    if index is not None:
        index = np.ascontiguousarray(index, np.int32)
        if index.shape != (num_streams, num_elements):
            raise ValueError("index shape must be [num_streams, n]")
        if index.size and (index.min() < 0 or index.max() >= t.num_rows):
            raise ValueError("index out of range")
        idx_p = _i32p(index)

    in_lengths = np.asarray([len(s) for s in strings], np.int32)
    in_stride = int(in_lengths.max(initial=0)) or 1
    buf = np.zeros((num_streams, in_stride), np.uint8)
    for s, b in enumerate(strings):
        buf[s, : len(b)] = np.frombuffer(b, np.uint8)

    cdf, length, precision, overflow = _table_arrays(t)
    out = np.zeros((num_streams, num_elements), np.int32)
    sanity = np.zeros(num_streams, np.uint8)
    rc = lib.ctpu_decode_streams(
        _u8p(buf), _i32p(in_lengths), in_stride, idx_p,
        num_streams, num_elements,
        _i32p(cdf), _i32p(length), _i32p(precision), _u8p(overflow),
        t.num_rows, t.cdf.shape[1],
        _i32p(out), _u8p(sanity),
        num_threads or _num_threads(num_streams))
    if rc != 0:
        raise RuntimeError(f"native decode failed ({rc})")
    return out, sanity != 0
