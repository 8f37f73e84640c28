"""Bit coder and run-length / gamma / Rice codes (PyTorch port's counterpart
of compression_tpu/ops/run_length.py).

The reference's little-endian LSB-first bit I/O (cc/lib/bit_coder.cc:54-189)
and its run-length coding ops:

  * run_length_gamma_{encode,decode}: zero runs as Elias-gamma(run+1), then
    sign bit + gamma magnitude (cc/kernels/run_length_gamma_kernels.cc).
  * run_length_{encode,decode}: run-length and magnitude each selectable
    Rice(k) (k >= 0) or gamma (code < 0), with optional run-length coding of
    the nonzero runs (cc/kernels/run_length_kernels.cc:53-261).

These codes are the byte-stream formats of the PowerLaw and Laplace entropy
models.  They are host code, numpy in and bytes out: the four public
functions run the C library native/host_codecs.c, built with the C compiler
at first use, and raise when it cannot be built (there is no slower route).
``BitWriter`` / ``BitReader`` and the ``plain_*`` functions are the same
codes in Python, the plain version the C library is held against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from compression_tpu_torch import native
from compression_tpu_torch.util.device import host_array

__all__ = [
    "BitWriter",
    "BitReader",
    "run_length_gamma_encode",
    "run_length_gamma_decode",
    "run_length_encode",
    "run_length_decode",
    "plain_run_length_gamma_encode",
    "plain_run_length_gamma_decode",
    "plain_run_length_encode",
    "plain_run_length_decode",
]

_INT32_MIN = -(2**31)


class BitWriter:
    """LSB-first bit writer (little-endian byte order)."""

    def __init__(self):
        self._bytes = bytearray()
        self._buffer = 0
        self._bits = 0

    def write_bits(self, count: int, bits: int):
        self._buffer |= (bits & ((1 << count) - 1)) << self._bits
        self._bits += count
        while self._bits >= 8:
            self._bytes.append(self._buffer & 0xFF)
            self._buffer >>= 8
            self._bits -= 8

    def write_one_bit(self, bit: int):
        self.write_bits(1, bit)

    def write_gamma(self, value: int):
        """Elias gamma: unary length prefix (zeros), then binary LSBs."""
        assert value > 0
        bit_width = value.bit_length()
        self.write_bits(bit_width - 1, 0)
        self.write_bits(1, 1)
        self.write_bits(bit_width - 1, value)

    def write_rice(self, value: int, parameter: int):
        assert value >= 0 and parameter >= 0
        self.write_bits(value >> parameter, 0)
        self.write_bits(1, 1)
        self.write_bits(parameter, value)

    def get_data(self) -> bytes:
        out = bytes(self._bytes)
        if self._bits:
            out += bytes([self._buffer & 0xFF])
        return out


class BitReader:
    """LSB-first bit reader matching BitWriter."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self._buffer = 0
        self._bits = 0

    def read_bits(self, count: int) -> int:
        while self._bits < count:
            if self._pos >= len(self._data):
                raise ValueError("Out of bits to read.")
            self._buffer |= self._data[self._pos] << self._bits
            self._pos += 1
            self._bits += 8
        bits = self._buffer & ((1 << count) - 1)
        self._buffer >>= count
        self._bits -= count
        return bits

    def read_one_bit(self) -> int:
        return self.read_bits(1)

    def read_gamma(self) -> int:
        bit_width = 1
        while not self.read_one_bit():
            bit_width += 1
            if bit_width > 31:
                raise ValueError("Exceeded maximum gamma bit width.")
        msb = 1 << (bit_width - 1)
        return msb | self.read_bits(bit_width - 1)

    def read_rice(self, parameter: int) -> int:
        msbs = 0
        while not self.read_one_bit():
            msbs += 1
        return (msbs << parameter) | self.read_bits(parameter)


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _symbols(data, what):
    return np.ascontiguousarray(host_array(data, what), np.int32).ravel()


def _capacity(arr, magnitude_code=-1):
    """Bytes that bound any code of ``arr``: at most 24 bytes a sample for
    the gamma parts, plus the unary prefixes of the Rice parts (runs sum
    to at most the sample count; magnitudes shifted by ``magnitude_code``)."""
    extra = arr.size
    if magnitude_code >= 0:
        extra += int((np.abs(arr.astype(np.int64)) >> magnitude_code).sum())
    return 24 * arr.size + 64 + extra // 8 + 1


def _encoded(out, n, what):
    if n < 0:
        raise RuntimeError(f"{what}: the code outgrew its buffer.")
    return out[:n].tobytes()


def _decoded(rc, out, shape):
    if rc != 0:
        raise ValueError("Decoded past end of tensor or out of bits.")
    return out.reshape(shape)


def run_length_gamma_encode(data) -> bytes:
    """Zero-run + sign + gamma-magnitude code over an int array (numpy or
    a CPU tensor), by the C library."""
    lib = native.get_host_codecs_lib()
    arr = _symbols(data, "run_length_gamma_encode")
    cap = _capacity(arr)
    out = np.empty(cap, np.uint8)
    n = lib.rlg_encode(arr.ctypes.data_as(_I32P), arr.size,
                       out.ctypes.data_as(_U8P), cap)
    return _encoded(out, n, "run_length_gamma_encode")


def run_length_gamma_decode(code: bytes, shape) -> np.ndarray:
    """Inverse of run_length_gamma_encode: int32 numpy of ``shape``."""
    lib = native.get_host_codecs_lib()
    size = int(np.prod(shape))
    buf = np.frombuffer(bytes(code), np.uint8)
    out = np.zeros(size, np.int32)
    rc = lib.rlg_decode(buf.ctypes.data_as(_U8P), buf.size,
                        out.ctypes.data_as(_I32P), size)
    return _decoded(rc, out, shape)


def run_length_encode(data, run_length_code=-1, magnitude_code=-1,
                      use_run_length_for_non_zeros=False) -> bytes:
    """General run-length code with selectable Rice (k >= 0) or gamma
    (< 0) sub-codes, by the C library."""
    lib = native.get_host_codecs_lib()
    arr = _symbols(data, "run_length_encode")
    cap = _capacity(arr, int(magnitude_code))
    out = np.empty(cap, np.uint8)
    n = lib.rl_encode(
        arr.ctypes.data_as(_I32P), arr.size, int(run_length_code),
        int(magnitude_code), int(bool(use_run_length_for_non_zeros)),
        out.ctypes.data_as(_U8P), cap)
    return _encoded(out, n, "run_length_encode")


def run_length_decode(code: bytes, shape, run_length_code=-1,
                      magnitude_code=-1,
                      use_run_length_for_non_zeros=False) -> np.ndarray:
    """Inverse of run_length_encode: int32 numpy of ``shape``."""
    lib = native.get_host_codecs_lib()
    size = int(np.prod(shape))
    buf = np.frombuffer(bytes(code), np.uint8)
    out = np.zeros(size, np.int32)
    rc = lib.rl_decode(
        buf.ctypes.data_as(_U8P), buf.size, out.ctypes.data_as(_I32P), size,
        int(run_length_code), int(magnitude_code),
        int(bool(use_run_length_for_non_zeros)))
    return _decoded(rc, out, shape)


# -- the plain version: the same codes on BitWriter / BitReader --------------
def plain_run_length_gamma_encode(data) -> bytes:
    """run_length_gamma_encode in Python."""
    data = _symbols(data, "plain_run_length_gamma_encode").astype(np.int64)
    enc = BitWriter()
    zero_ct = 1
    for sample in data:
        sample = int(sample)
        if sample == 0:
            zero_ct += 1
        else:
            enc.write_gamma(zero_ct)
            enc.write_one_bit(1 if sample > 0 else 0)
            if sample == _INT32_MIN:
                sample += 1
            enc.write_gamma(abs(sample))
            zero_ct = 1
    if zero_ct > 1:
        enc.write_gamma(zero_ct)
    return enc.get_data()


def plain_run_length_gamma_decode(code: bytes, shape) -> np.ndarray:
    """run_length_gamma_decode in Python."""
    size = int(np.prod(shape))
    out = np.zeros(size, np.int32)
    dec = BitReader(code)
    i = 0
    while i < size:
        run = dec.read_gamma() - 1
        i += run
        if i >= size:
            if i != size:
                raise ValueError("Decoded past end of tensor.")
            break
        sign = dec.read_one_bit()
        mag = dec.read_gamma()
        out[i] = mag if sign else -mag
        i += 1
    return out.reshape(shape)


def _write_run_length(enc, run_length, run_length_code):
    if run_length_code >= 0:
        enc.write_rice(run_length, run_length_code)
    else:
        enc.write_gamma(run_length + 1)


def _read_run_length(dec, run_length_code):
    if run_length_code >= 0:
        return dec.read_rice(run_length_code)
    return dec.read_gamma() - 1


def _write_non_zero(enc, sample, magnitude_code):
    assert sample != 0
    sign = 1 if sample > 0 else 0
    enc.write_one_bit(sign)
    if magnitude_code >= 0:
        enc.write_rice(sample - 1 if sign else -(sample + 1), magnitude_code)
    elif sample == _INT32_MIN:
        enc.write_gamma(-(_INT32_MIN + 1))
    else:
        enc.write_gamma(sample if sign else -sample)


def _read_non_zero(dec, magnitude_code):
    positive = dec.read_one_bit()
    if magnitude_code >= 0:
        rice = dec.read_rice(magnitude_code)
        return rice + 1 if positive else -rice - 1
    gamma = dec.read_gamma()
    return gamma if positive else -gamma


def plain_run_length_encode(data, run_length_code=-1, magnitude_code=-1,
                            use_run_length_for_non_zeros=False) -> bytes:
    """run_length_encode in Python."""
    data = _symbols(data, "plain_run_length_encode").astype(np.int64)
    enc = BitWriter()
    n = len(data)
    p = 0
    run_length_offset = 0
    while p < n:
        q = p
        while q < n and data[q] == 0:
            q += 1
        _write_run_length(enc, q - p - run_length_offset, run_length_code)
        p = q
        if p >= n:
            break
        if use_run_length_for_non_zeros:
            q = p
            while q < n and data[q] != 0:
                q += 1
            _write_run_length(enc, q - p - 1, run_length_code)
            while p < q:
                _write_non_zero(enc, int(data[p]), magnitude_code)
                p += 1
            run_length_offset = 1
        else:
            _write_non_zero(enc, int(data[p]), magnitude_code)
            p += 1
    return enc.get_data()


def plain_run_length_decode(code: bytes, shape, run_length_code=-1,
                            magnitude_code=-1,
                            use_run_length_for_non_zeros=False) -> np.ndarray:
    """run_length_decode in Python."""
    size = int(np.prod(shape))
    out = np.zeros(size, np.int32)
    dec = BitReader(code)
    p = 0
    run_length_offset = 0
    while p < size:
        run = _read_run_length(dec, run_length_code) + run_length_offset
        p += run
        if p >= size:
            if p != size:
                raise ValueError("Decoded past end of tensor.")
            break
        if use_run_length_for_non_zeros:
            nz = _read_run_length(dec, run_length_code) + 1
            if p + nz > size:
                raise ValueError("Decoded past end of tensor.")
            for _ in range(nz):
                out[p] = _read_non_zero(dec, magnitude_code)
                p += 1
            run_length_offset = 1
        else:
            out[p] = _read_non_zero(dec, magnitude_code)
            p += 1
    return out.reshape(shape)
