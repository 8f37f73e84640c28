"""Range-coder CDF table machinery.

Two representations are used:

* The **ragged wire format** of tensorflow/compression: a 1-D int32 vector (or
  a 2-D matrix with one padded row per CDF) of concatenated runs
  ``[precision, 0, c1, ..., 2**|precision|]``; a negative stored precision
  marks overflow/escape (Elias-gamma) mode, and padding repeats the terminal
  ``2**|precision|`` value.  This is what entropy models store and serialize,
  so checkpoints stay interchangeable with the reference
  (cc/kernels/range_coder_kernels.cc:110-164 ``ScanCDF``).

* A **dense device format** (`CdfTable`): a rectangular int32 array of CDF
  rows plus per-row precision/length/overflow vectors.  This is what the
  TPU kernels gather from (rows live in VMEM; symbol lookup is a vectorized
  compare over the padded row).

Also exposes ``pmf_to_quantized_cdf``, the exact greedy integer CDF
quantizer of the reference (cc/kernels/pmf_to_cdf_kernels.cc:159-208):
round to nearest with a floor of 1, then repair the sum to exactly
``2**precision`` by repeatedly adjusting the element with the smallest
entropy penalty (or largest gain), and finally prefix-sum.  It runs only
through the C++ quantizer in ``native/pmf_quantizer.cc``, whose
``std::sort`` tie order makes the tables byte-identical to the reference;
there is no Python fallback, so a missing C++ compiler raises.

Framework-free (numpy only): this package's own copy of
``compression_tpu/codec/tables.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

__all__ = [
    "CdfTable",
    "pmf_to_quantized_cdf",
    "parse_ragged_cdf",
    "build_ragged_cdf",
]


@dataclasses.dataclass
class CdfTable:
    """Dense CDF table for the range-coder kernels.

    Attributes:
      cdf: int32 [num_rows, max_len] CDF values per row, each row starting at 0
        and reaching ``2**precision`` at index ``length - 1``; padded to the
        right with ``2**precision`` (so vectorized searches never select
        padding).
      length: int32 [num_rows], number of valid CDF entries per row
        (= alphabet size + 1).
      precision: int32 [num_rows], positive range-coder precision per row.
      overflow: bool [num_rows], True if the row's last symbol is an escape
        that switches to Elias-gamma coding of out-of-range values.
    """

    cdf: np.ndarray
    length: np.ndarray
    precision: np.ndarray
    overflow: np.ndarray

    @property
    def num_rows(self) -> int:
        return self.cdf.shape[0]

    @property
    def max_len(self) -> int:
        return self.cdf.shape[1]

    def max_value(self, row: int) -> int:
        """Escape symbol index for overflow rows (alphabet size - 1)."""
        return int(self.length[row]) - 2


def pmf_to_quantized_cdf(pmf, precision: int) -> np.ndarray:
    """Quantizes a PMF to an integer CDF summing exactly to 2**precision.

    Matches the greedy steal/grant semantics of the reference kernel
    (cc/kernels/pmf_to_cdf_kernels.cc:159-208): every symbol gets at least
    mass 1; the sum is repaired one unit at a time, each time picking the
    symbol whose change costs the least (penalty ``mass * dlog2`` when
    stealing) or gains the most; ties resolve in favor of the
    earliest-sorted symbol, with re-insertion after all equal keys.
    Ties in the seed sort follow libstdc++'s ``std::sort``.

    Args:
      pmf: 1-D array of non-negative floats.
      precision: int in [1, 16].

    Returns:
      int32 array of size ``len(pmf) + 1``; cdf[0] == 0,
      cdf[-1] == 2**precision.
    """
    pmf = np.asarray(pmf, dtype=np.float32)
    if pmf.ndim != 1:
        raise ValueError("pmf must be 1-D")
    if not (0 < precision <= 16):
        raise ValueError(f"precision must be in [1, 16]: {precision}")
    if not np.all(np.isfinite(pmf)) or np.any(pmf < 0):
        raise ValueError("pmf has non-finite or negative element")

    from compression_tpu_torch import native

    lib = native.get_pmf_lib()  # raises when the quantizer cannot be built
    pmf_c = np.ascontiguousarray(pmf, np.float32)
    out = np.empty(len(pmf) + 1, np.int32)
    rc = lib.pmf_to_quantized_cdf(
        pmf_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(len(pmf)), ctypes.c_int(precision),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed with code {rc}")
    return out


def parse_ragged_cdf(table) -> CdfTable:
    """Parses the reference's ragged CDF vector/matrix into a dense table."""
    table = np.asarray(table, dtype=np.int32)
    rows = []
    if table.ndim == 1:
        flat = table
        pos = 0
        end = len(flat)
        while pos < end:
            pos, row = _scan_one(flat, pos, end)
            rows.append(row)
    elif table.ndim == 2:
        for r in range(table.shape[0]):
            flat = table[r]
            pos, row = _scan_one(flat, 0, len(flat))
            last = row[2][-1]
            if not np.all(flat[pos:] == last):
                raise ValueError("CDF row has trailing garbage after padding")
            rows.append(row)
    else:
        raise ValueError("ragged cdf must be rank 1 or 2")

    num_rows = len(rows)
    max_len = max(len(r[2]) for r in rows)
    cdf = np.zeros((num_rows, max_len), np.int32)
    length = np.zeros(num_rows, np.int32)
    precision = np.zeros(num_rows, np.int32)
    overflow = np.zeros(num_rows, bool)
    for r, (prec, ovf, vals) in enumerate(rows):
        cdf[r, : len(vals)] = vals
        cdf[r, len(vals):] = vals[-1]
        length[r] = len(vals)
        precision[r] = prec
        overflow[r] = ovf
    return CdfTable(cdf, length, precision, overflow)


def _scan_one(flat, pos, end):
    """Scans one ragged run; mirrors ScanCDF's validation."""
    if end < pos + 3:
        raise ValueError("CDF ended prematurely")
    stored = int(flat[pos])
    prec = abs(stored)
    if not (1 <= prec <= 16):
        raise ValueError(f"invalid precision {stored}")
    last_value = 1 << prec
    if flat[pos + 1] != 0:
        raise ValueError("CDF must start with 0")
    p = pos + 1
    while True:
        p += 1
        if p == end:
            raise ValueError("CDF must end with 1 << precision")
        if flat[p] < flat[p - 1]:
            raise ValueError("CDF must be monotonically increasing")
        if flat[p] == last_value:
            break
    vals = flat[pos + 1 : p + 1].copy()
    p += 1
    while p < end and flat[p] == last_value:
        p += 1
    return p, (prec, stored < 0, vals)


def build_ragged_cdf(cdfs, precisions, overflows) -> np.ndarray:
    """Concatenates per-row CDFs into the reference's 1-D ragged format."""
    parts = []
    for vals, prec, ovf in zip(cdfs, precisions, overflows):
        stored = -int(prec) if ovf else int(prec)
        parts.append(np.asarray([stored], np.int32))
        parts.append(np.asarray(vals, np.int32))
    return np.concatenate(parts) if parts else np.zeros((0,), np.int32)
