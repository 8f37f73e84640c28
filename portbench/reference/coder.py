"""A plain range decoder for the two containers' streams, from TFC's coder
(cc/lib/range_coder.{h,cc}: 32-bit interval, 16-bit renormalization,
Elias-gamma escapes in cc/kernels/range_coder_kernels.cc).

``decode_stream`` decodes one stream element by element, each with the
CDF row that the reference's own hyper synthesis picks.  A row is the
integer part of a float that the sender computed in its own order of
float32 operations, so where the reference's value lies within a hair of
an integer the sender may have picked the row below or above.  There the
decoder tries both and keeps the one that decodes further into the
stream before ``MISSES`` of its values disagree with the reference's own
latents, then the one with fewer such values, then the one that ends the
stream as the encoder ended it.  The wrong row shifts the decoder's
interval: by a lot, and its values drift from the latents within a few
elements, or by a hair, and a value goes wrong only now and then, so a
tie over ``LOOKAHEAD`` elements makes the look-ahead four times longer, up
to the stream's end.  A look-ahead that meets another ambiguous element
follows the better of that element's two rows too (up to ``BRANCHES``
deep), since its nominal row may be the wrong one and would stop the
right path as well.  Two rows that leave the decoder in one state with
one value are the same choice.
"""

from __future__ import annotations

from bisect import bisect_left

MASK = 0xFFFFFFFF
LOOKAHEAD = 96
BRANCHES = 4
MISSES = 4
_BINARY = (0, 1, 2)


class Decoder:
    """One stream's decoder state: (pos, base, size - 1, value)."""

    __slots__ = ("data", "pos", "base", "size1", "value")

    def __init__(self, data):
        self.data = bytes(data)
        self.pos = 0
        self.base = 0
        self.size1 = MASK
        self.value = 0
        self._read16()
        self._read16()

    def _read16(self):
        data, pos, value = self.data, self.pos, self.value
        for _ in range(2):
            value = (value << 8) & MASK
            if pos < len(data):
                value |= data[pos]
                pos += 1
        self.pos, self.value = pos, value

    def state(self):
        return self.pos, self.base, self.size1, self.value

    def restore(self, state):
        self.pos, self.base, self.size1, self.value = state

    def decode(self, cdf, precision):
        """The symbol s with cdf[s] <= the scaled value < cdf[s + 1]."""
        size = self.size1 + 1
        target = ((((self.value - self.base) & MASK) + 1) << precision)
        # The least pv in [1, len - 1] with size * cdf[pv] >= target.
        pv = bisect_left(cdf, -(-target // size), 1, len(cdf) - 1)
        a = (size * cdf[pv - 1]) >> precision
        b = ((size * cdf[pv]) >> precision) - 1
        self.base = (self.base + a) & MASK
        self.size1 = (b - a) & MASK
        if self.size1 >> 16 == 0:
            self.base = (self.base << 16) & MASK
            self.size1 = ((self.size1 << 16) | 0xFFFF) & MASK
            self._read16()
        return pv - 1

    def decode_gamma(self, cdf, precision):
        """A symbol with TFC's overflow coding: the escape (the last
        symbol), then an Elias-gamma number and a sign bit."""
        max_value = len(cdf) - 2
        symbol = self.decode(cdf, precision)
        if symbol != max_value:
            return symbol
        n = 0
        while self.decode(_BINARY, 1) == 0:
            n += 1
            if n > 62:
                return None
        value = 1 << n
        for bit in range(n - 1, -1, -1):
            value |= self.decode(_BINARY, 1) << bit
        if self.decode(_BINARY, 1):
            return -value
        return value + max_value - 1

    def finished(self):
        """TFC's decoder check: the whole stream was read, and the value
        is the number the encoder's finalization wrote."""
        if self.pos != len(self.data):
            return False
        upper = (self.base + self.size1) & MASK
        if self.base == 0 or upper < self.base:
            return self.value == 0
        shift = 24 if ((self.base - 1) >> 24) < (upper >> 24) else 16
        return (((((self.base - 1) >> shift) + 1) << shift) & MASK) \
            == self.value


def decode_stream(data, table, rows, expected, alternatives=None,
                  sidecar=None):
    """Decodes one stream.

    Args:
      data: the stream's bytes.
      table: a ``tables.Table``.
      rows: the CDF row of each element (list of ints).
      expected: the reference's value of each element (ints), which the
        decoder only uses to choose between two rows where ``alternatives``
        offers one.
      alternatives: {element: the other row} where the row is ambiguous.
      sidecar: None for in-stream escapes (the classic container), else
        {element: symbol} of the escapes that the native container keeps
        beside the stream; an element that decodes as the escape takes its
        symbol from there.

    Returns:
      (values, ok, ambiguous): the decoded values (symbol plus the row's
      offset; None where a stream broke), whether the stream ended where
      the encoder ended it and every escape was accounted for, and how
      many ambiguous rows were met.
    """
    alternatives = alternatives or {}
    dec = Decoder(data)
    cdfs, offsets, prec = table.rows, table.offsets, table.precision
    n = len(rows)
    used = set()

    def one(j, row):
        cdf = cdfs[row]
        if sidecar is None:
            symbol = dec.decode_gamma(cdf, prec)
            if symbol is None:
                return None
        else:
            symbol = dec.decode(cdf, prec)
            if symbol == len(cdf) - 2:
                symbol = sidecar.get(j)
                if symbol is None:
                    return None
                used.add(j)
        return symbol + offsets[row]

    def score(j, row, end, branches, misses=MISSES):
        """(elements decoded from j on, with ``row`` at j, before the
        ``misses``-th that disagrees with ``expected``, up to end; misses
        left; whether the stream ended there as the encoder ended it).  A
        later ambiguous element takes the better of its two rows while
        ``branches`` last.  Leaves the decoder as it was."""
        start, marks = dec.state(), set(used)
        count, done = 0, False
        for i in range(j, end):
            if i > j and branches and i in alternatives:
                best = max(score(i, r, end, branches - 1, misses)
                           for r in (rows[i], alternatives[i]))
                count, misses, done = count + best[0], best[1], best[2]
                break
            v = one(i, row if i == j else rows[i])
            if v is None:
                break
            if v != expected[i]:
                misses -= 1
                if not misses:
                    break
            count += 1
        else:
            done = end == n and dec.finished() and (
                sidecar is None or len(used) == len(sidecar))
        dec.restore(start)
        used.clear()
        used.update(marks)
        return count, misses, done

    def after(j, row):
        """(value, decoder state) of element j decoded with ``row``; leaves
        the decoder as it was."""
        start, marks = dec.state(), set(used)
        out = one(j, row), dec.state()
        dec.restore(start)
        used.clear()
        used.update(marks)
        return out

    def choose(j, row, alt):
        if after(j, row) == after(j, alt):
            return row
        look = LOOKAHEAD
        while True:
            end = min(n, j + look)
            a = score(j, row, end, BRANCHES)
            b = score(j, alt, end, BRANCHES)
            if a != b or end == n:
                return alt if b > a else row
            look *= 4

    values = [None] * n
    ok = True
    for j in range(n):
        row = rows[j]
        alt = alternatives.get(j)
        if alt is not None:
            row = choose(j, row, alt)
        v = one(j, row)
        if v is None:
            ok = False
            break
        values[j] = v
    if sidecar is not None and len(used) != len(sidecar):
        ok = False
    return values, ok and dec.finished(), len(alternatives)
