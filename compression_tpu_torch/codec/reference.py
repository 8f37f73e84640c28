"""Bit-exact scalar reference implementation of the range codec.

This package's own copy of ``compression_tpu/codec/reference.py``, the
*specification* the coders are held to.  It reimplements, from the
algorithm description, the carry-less range coder of G.N.N. Martin (1979)
with the exact integer recurrences used by tensorflow/compression (see
reference cc/lib/range_coder.{h,cc}):

  * 32-bit interval arithmetic over ``[base, base + size)`` with the invariant
    ``2**16 <= size <= 2**32`` (``size`` stored as ``size - 1``),
  * 16-bit renormalization chunks,
  * a delayed-carry mechanism ("state 1") instead of carry propagation:
    when the interval straddles a 2**16-renormalization boundary the emitted
    chunk is deferred; later interval refinements resolve it either up
    (emit ``delay`` followed by 0x00 bytes) or down (emit ``delay - 1``
    followed by 0xFF bytes),
  * the finalization rules that pick a short number inside the final interval
    (rounding base up to a multiple of 2**24 or 2**16) and drop implicit
    trailing zeros.

Everything here is plain Python and deliberately slow; it exists to
adjudicate any disagreement between the CUDA kernels, their plain PyTorch
versions, the host C coder and the reference semantics.

Reference parity targets (file:line in /root/reference):
  RangeEncoder::Encode     cc/lib/range_coder.cc:37-264
  RangeEncoder::Finalize   cc/lib/range_coder.cc:266-307
  RangeDecoder::Decode     cc/lib/range_coder.h:224-271
  RangeDecoder::Finalize   cc/lib/range_coder.h:144-169
"""

from __future__ import annotations

U32 = (1 << 32) - 1  # uint32 mask


class RangeEncoder:
    """Scalar range encoder (one stream). Bit-exact w.r.t. the spec above."""

    def __init__(self):
        self.base = 0  # uint32
        self.size_minus1 = U32  # uint32
        # Delayed-carry state. ``delay & 0xFFFF`` is the deferred 16-bit chunk
        # value plus one; ``delay >> 16`` counts deferred zero bytes.
        self.delay = 0

    def encode(self, lower: int, upper: int, precision: int, sink: bytearray):
        """Narrows the interval to [lower, upper) / 2**precision.

        Requires 0 <= lower < upper <= 2**precision and 0 < precision <= 16.
        """
        assert 0 < precision <= 16, precision
        assert 0 <= lower < upper <= (1 << precision), (lower, upper, precision)
        size = self.size_minus1 + 1
        # New sub-interval endpoints (floor scaling).
        a = (size * lower) >> precision
        b = ((size * upper) >> precision) - 1
        assert a <= b

        new_base = (self.base + a) & U32
        base_overflow = new_base < a  # did base wrap past 2**32?
        self.base = new_base
        self.size_minus1 = (b - a) & U32

        if (self.base + self.size_minus1) > U32:
            # State 1: interval straddles 2**32. Can only happen if we were
            # already in state 1 (refinement cannot create a straddle).
            assert self.delay & 0xFFFF != 0
            if self.size_minus1 >> 16 == 0:
                # Renormalize within state 1: the straddle means the top 16
                # bits of base are 0xFFFF and of (base+size-1) are 0x0000, so
                # the eventual chunk is either 0xFFFF... or 0x0000... -> defer
                # two more bytes.
                assert self.base >> 16 == 0xFFFF
                self.base = (self.base << 16) & U32
                self.size_minus1 = ((self.size_minus1 << 16) | 0xFFFF) & U32
                self.delay += 0x20000  # two more deferred zero bytes
            return

        # State 0 now. If we were in state 1, the straddle has resolved;
        # flush the deferred chunk.
        if self.delay != 0:
            if base_overflow:
                # Interval moved above 2**32: deferred value resolves up.
                sink.append((self.delay >> 8) & 0xFF)
                sink.append(self.delay & 0xFF)
                sink.extend(b"\x00" * (self.delay >> 16))
            else:
                # Interval moved below 2**32: resolves down (borrow).
                d = self.delay - 1
                sink.append((d >> 8) & 0xFF)
                sink.append(d & 0xFF)
                sink.extend(b"\xFF" * (d >> 16))
            self.delay = 0

        if self.size_minus1 >> 16 == 0:
            # Renormalize: emit (or defer) the top 16 bits of base.
            top = self.base >> 16
            self.base = (self.base << 16) & U32
            self.size_minus1 = ((self.size_minus1 << 16) | 0xFFFF) & U32
            if self.base + self.size_minus1 <= U32:
                # Unambiguous chunk.
                sink.append((top >> 8) & 0xFF)
                sink.append(top & 0xFF)
            else:
                # New interval straddles 2**32: enter state 1.
                assert top < 0xFFFF
                self.delay = top + 1

    def finalize(self, sink: bytearray):
        """Emits a number inside [base, base+size), dropping implicit zeros."""
        if self.delay != 0:
            # State 1: pick 2**32, i.e. the deferred value itself; trailing
            # zero bytes are implicit.
            sink.append((self.delay >> 8) & 0xFF)
            if self.delay & 0xFF:
                sink.append(self.delay & 0xFF)
        elif self.base != 0:
            upper = (self.base + self.size_minus1) & U32
            assert self.base <= upper
            # Try rounding base up to a multiple of 2**24 (1 byte output).
            mid24 = ((self.base - 1) >> 24) + 1
            if mid24 <= (upper >> 24):
                sink.append(mid24 & 0xFF)
            else:
                # Round up to a multiple of 2**16 (2 bytes, low dropped if 0).
                mid16 = ((self.base - 1) >> 16) + 1
                assert mid16 <= 0xFFFF
                sink.append((mid16 >> 8) & 0xFF)
                if mid16 & 0xFF:
                    sink.append(mid16 & 0xFF)
        # base == 0 in state 0: all-zero suffix is implicit; write nothing.


class RangeDecoder:
    """Scalar range decoder (one stream). Mirrors RangeEncoder."""

    def __init__(self, source: bytes):
        self.source = source
        self.pos = 0
        self.base = 0
        self.size_minus1 = U32
        self.value = 0
        self.corrupt = False
        self._read16()
        self._read16()

    def _read16(self):
        for _ in range(2):
            self.value = (self.value << 8) & U32
            if self.pos < len(self.source):
                self.value |= self.source[self.pos]
                self.pos += 1

    def decode(self, cdf, precision: int) -> int:
        """Decodes one symbol given a CDF (cdf[0] == 0, last <= 2**precision).

        Returns the index i such that cdf[i] <= scaled value < cdf[i+1].
        """
        assert 0 < precision <= 16
        size = self.size_minus1 + 1
        lower_bound = ((self.value - self.base) & U32) + 1 << precision

        # Find the smallest index pv in [1, len) with
        # lower_bound <= size * cdf[pv]  (linear scan; semantics identical to
        # the reference's binary search).
        n = len(cdf)
        pv = 1
        while pv < n - 1 and size * int(cdf[pv]) < lower_bound:
            pv += 1
        # pv now in [1, n-1]; decode error if the condition still fails at the
        # last entry (we do not check, same as the reference's DCHECK).

        a = (size * int(cdf[pv - 1])) >> precision
        b = ((size * int(cdf[pv])) >> precision) - 1
        self.base = (self.base + a) & U32
        self.size_minus1 = (b - a) & U32

        if self.size_minus1 >> 16 == 0:
            self.base = (self.base << 16) & U32
            self.size_minus1 = ((self.size_minus1 << 16) | 0xFFFF) & U32
            self._read16()
        return pv - 1

    def finalize(self) -> bool:
        """Weak sanity check that the stream was fully consumed."""
        if self.corrupt or self.pos != len(self.source):
            return False
        upper = (self.base + self.size_minus1) & U32
        if self.base == 0 or upper < self.base:
            return self.value == 0
        shift = 24 if ((self.base - 1) >> 24) < (upper >> 24) else 16
        mid = ((self.base - 1) >> shift) + 1
        return ((mid << shift) & U32) == self.value


# -----------------------------------------------------------------------------
# Overflow (Elias gamma) embedding, mirroring the stateful coder ops
# (reference cc/kernels/range_coder_kernels.cc:290-322 encode, :449-471 decode).
# -----------------------------------------------------------------------------
def overflow_encode(encoder: RangeEncoder, sink: bytearray, cdf, precision: int,
                    value: int):
    """Encodes a (possibly out-of-range) integer with escape + Elias gamma.

    ``cdf`` has ``max_value + 2`` entries; symbol ``max_value`` is the escape.
    """
    max_value = len(cdf) - 2
    assert max_value >= 0
    sign = value < 0
    gamma = None
    if sign:
        gamma = -value
        value = max_value
    elif value >= max_value:
        gamma = value - max_value + 1
        value = max_value
    encoder.encode(int(cdf[value]), int(cdf[value + 1]), precision, sink)
    if value != max_value:
        return
    # Elias gamma: unary length prefix in zero bits, then the value's bits
    # MSB-first (leading 1 included), each as a binary uniform symbol.
    n = 1
    while gamma >= (1 << n):
        encoder.encode(0, 1, 1, sink)
        n += 1
    n -= 1
    while n >= 0:
        bit = (gamma >> n) & 1
        encoder.encode(bit, bit + 1, 1, sink)
        n -= 1
    encoder.encode(int(sign), int(sign) + 1, 1, sink)


def overflow_decode(decoder: RangeDecoder, cdf, precision: int) -> int:
    """Decodes an integer encoded by overflow_encode."""
    binary_uniform = (0, 1, 2)
    max_value = len(cdf) - 2
    value = decoder.decode(cdf, precision)
    if value != max_value:
        return value
    n = 0
    while decoder.decode(binary_uniform, 1) == 0:
        n += 1
        # A corrupted stream can hit a fixed point where every binary
        # decode yields 0 forever (zero-filled tail keeps value-base at 0
        # through renorm).  Real encoders never exceed ~34 unary bits
        # (int32 magnitudes), so cap and flag the stream as corrupt.
        if n > 62:
            decoder.corrupt = True
            return 0
    value = 1 << n
    n -= 1
    while n >= 0:
        value |= decoder.decode(binary_uniform, 1) << n
        n -= 1
    sign = decoder.decode(binary_uniform, 1)
    return -value if sign else value + max_value - 1
