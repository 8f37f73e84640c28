"""The warp-per-stream in-stream-gamma decode (K3') on the CPU: its 16-bit
table layout and lane-strided search against the dense search of
``_PlainDecoder.symbol``, a plain decoder built on that search against the
JAX package's ``decode_streams`` (escapes and corrupt streams included),
the choice of the variant from the launch's shape, and the pair lookup
(K7') at element counts that are not multiples of four.

Every comparison is exact: counts, symbols, intervals, decoder states and
sanity flags are integers.
"""

import os

import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder

torch.set_num_threads(1)

GOLDEN_FULL = os.path.join(os.path.dirname(__file__), "golden",
                           "golden_bmshj_full.npz")


def _dense_table(rows, precisions, overflow=True):
    """DeviceCdfTable on the CPU from CDF rows given as they are (each from
    0 to 2^precision, non-decreasing), padded with their terminal value."""
    max_len = max(len(r) for r in rows)
    cdf = np.stack([np.concatenate(
        [r, np.full(max_len - len(r), r[-1])]) for r in rows]).astype(
            np.int32)
    return torch_coder.DeviceCdfTable(tables.CdfTable(
        cdf, np.asarray([len(r) for r in rows], np.int32),
        np.asarray(precisions, np.int32),
        np.full(len(rows), overflow)), "cpu")


def _random_row(rng, entries, precision):
    """A row of ``entries`` values: 0, sorted random values (runs of equal
    entries where they collide), 2^precision."""
    inner = np.sort(rng.randint(0, (1 << precision) + 1, entries - 2))
    return np.concatenate([[0], inner, [1 << precision]])


def _layout_table(name):
    rng = np.random.RandomState(sorted(LAYOUT_CASES).index(name))
    kind = LAYOUT_CASES[name]
    if kind == "golden":
        gold = np.load(GOLDEN_FULL)
        host = tables.parse_ragged_cdf(gold["cdf_y"])
        return torch_coder.DeviceCdfTable(host, "cpu")
    if kind == "ragged":
        # Precisions 1 to 16, 2 to 60 entries, row 0 at precision 16.
        precs = [16] + [int(p) for p in rng.randint(1, 17, 15)]
        rows = [_random_row(rng, int(rng.randint(2, 61)), p) for p in precs]
        return _dense_table(rows, precs)
    if kind == "runs":
        # Long runs of equal entries, at the start (zeros), inside and at
        # the end (the terminal value repeated), at precisions 16 and 9.
        rows = [np.repeat([0, 0, 7, 7, 7, 30000, 65536, 65536],
                          [1, 9, 11, 1, 20, 40, 3, 5]),
                np.repeat([0, 100, 512], [3, 70, 2]),
                np.asarray([0, 65536]), np.asarray([0, 0, 65536, 65536])]
        return _dense_table(rows, [16, 9, 16, 16])
    entries, precision = kind
    precs = [precision, max(precision - 3, 1), precision]
    rows = [_random_row(rng, entries, precs[0]),
            _random_row(rng, max(entries // 2, 2), precs[1]),
            np.unique(_random_row(rng, entries, precs[2]))]
    return _dense_table(rows, precs)


# name -> "golden", "ragged", "runs" or (entries of the longest row,
# precision).  129 entries are the most of the one-level search, 1481 those
# of bmshj2018's y table, 2101 need a third round of coarse probes.
LAYOUT_CASES = {
    "golden_y": "golden", "ragged_p1_16": "ragged", "runs": "runs",
    "len2_p16": (2, 16), "len33_p16": (33, 16), "len34_p12": (34, 12),
    "len129_p16": (129, 16), "len130_p16": (130, 16),
    "len1481_p16": (1481, 16), "len2101_p16": (2101, 16),
}


def _thresholds(cdf, meta, sizes):
    """(row, size, value - base) int64 [M]: for every entry of every row and
    every size, the decoder offsets whose lower bound lies just below, at
    and just above ``size * entry``."""
    num_rows, max_len = cdf.shape
    row = torch.arange(num_rows).repeat_interleave(max_len)
    entry = cdf.long().reshape(-1)
    prec = meta[:, 1].long()[row]
    out = []
    for size in sizes:
        size = torch.full_like(entry, size)
        # (off + 1) << prec compared with size * entry.
        at = (size * entry) >> prec
        for d in (-2, -1, 0, 1):
            out.append((row, size, (at + d).clamp(0, size[0] - 1)))
    return tuple(torch.cat(t) for t in zip(*out))


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_layout_and_search_match_plain_decoder(name):
    """warp_table + warp_search_plain give _PlainDecoder.symbol's count,
    symbol and interval (the state after the step) for thresholds at, just
    below and just above every entry."""
    table = _layout_table(name)
    cdf, meta = table.indexed_arrays()
    num_rows, max_len = cdf.shape
    layout = cuda_coder.warp_table(cdf, meta)
    assert layout.dtype == torch.int16 and layout.numel() % 8 == 0
    assert torch.equal(layout, table.warp_arrays())
    assert table.warp_arrays() is table.warp_arrays()
    row, size, off = _thresholds(cdf, meta, (1 << 16, 1 << 32, 0x9E3779B1))
    prec = meta[:, 1].long()[row]
    lower_bound = (off + 1) << prec
    dense = cuda_coder._dense_search(cdf.long()[row], size, lower_bound)
    warp = cuda_coder.warp_search_plain(layout, num_rows, max_len, row, size,
                                        lower_bound)
    for a, b in zip(dense, warp):
        assert torch.equal(a, b)
    # The thresholds reach from the first symbol to the last one of the
    # longest row.
    last = int((cdf.long() < cdf.long()[:, -1:]).sum(1).max()) - 1
    assert int(dense[0].min()) == 0 and int(dense[0].max()) == last

    def stepped(search):
        zeros = torch.zeros((row.shape[0], 8), dtype=torch.uint8)
        dec = cuda_coder._PlainDecoder(
            zeros, torch.full((row.shape[0],), 8, dtype=torch.int32))
        dec.sm1.copy_(size - 1)
        dec.value.copy_(off)
        sym = dec.symbol(search, max_len, prec)
        return sym, dec.base, dec.sm1, dec.value, dec.chunks_read

    searcher = cuda_coder._WarpSearch(layout, num_rows, max_len)
    ref = stepped(lambda s, lb: cuda_coder._dense_search(
        cdf.long()[row], s, lb))
    got = stepped(lambda s, lb: searcher(row, s, lb))
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_precision_16_terminal_is_exact():
    """65536 does not fit 16 bits: the layout stores a terminal entry less
    one, caps the count before the row's first terminal entry and gives
    the interval's end there from the row's metadata."""
    table = _layout_table("runs")
    cdf, meta = table.indexed_arrays()
    layout = cuda_coder.warp_table(cdf, meta)
    search = cuda_coder._WarpSearch(layout, *cdf.shape)
    assert int(cdf.max()) == 65536
    # (marker, precision, top, limit) per row.
    assert search.meta.tolist() == [[88, 16, 65536, 81], [73, 9, 512, 72],
                                    [0, 16, 65536, 0], [2, 16, 65536, 1]]
    assert int(search.tab[0, 82]) == 65535 and int(search.tab[0, 5]) == 0
    assert int(search.tab[1, 72]) == 100 and int(search.tab[1, 73]) == 511
    # The last symbol of row 0, at the top of the range and where 65535
    # tests below but 65536 does not: count 81, interval [30000, 65536).
    row = torch.zeros(2, dtype=torch.int64)
    size = torch.full((2,), 1 << 20)
    off = torch.stack([size[0] - 1, size[0] - 3])
    count, c_lo, c_hi = search(row, size, (off + 1) << 16)
    assert count.tolist() == [81, 81] and c_lo.tolist() == [30000, 30000]
    assert c_hi.tolist() == [65536, 65536]


def test_layout_fits_shared_memory_where_int32_does_not():
    """bmshj2018's y table: 379 KB as int32, under 227 KB less the rings'
    8 KB in the 16-bit layout."""
    table = _layout_table("golden_y")
    cdf, meta = table.indexed_arrays()
    assert cdf.numel() * 4 > 227 * 1024
    assert 2 * table.warp_arrays().numel() + 8 * 1024 <= 227 * 1024


# -- a plain decoder on that search against the JAX package -----------------
def _quantized_ragged(rng, alphabets, precisions, overflows):
    cdfs = [jax_tables.pmf_to_quantized_cdf(rng.dirichlet(np.full(a, 0.4)), p)
            for a, p in zip(alphabets, precisions)]
    return jax_tables.build_ragged_cdf(cdfs, list(precisions),
                                       list(overflows))


# name -> (alphabet sizes, precisions, overflow flags, streams, symbols,
# Laplace scale of the data).
STREAM_CASES = {
    "short_rows": ([3, 17, 40, 128, 9], [16, 12, 9, 16, 5],
                   [True, False, True, True, True], 6, 70, 15.0),
    "two_level": ([300, 129, 1480, 20], [16, 14, 16, 8],
                  [True, True, True, False], 3, 90, 120.0),
    "extremes": ([12, 30], [16, 10], [True, True], 8, 12, 4.0),
}
CORRUPTIONS = ["none", "truncated", "bitflip", "random", "empty", "tiny",
               "flips4"]


def _stream_case(name):
    rng = np.random.RandomState(sorted(STREAM_CASES).index(name) + 10)
    alphabets, precs, ovfs, s, n, scale = STREAM_CASES[name]
    ragged = _quantized_ragged(rng, alphabets, precs, ovfs)
    idx = rng.randint(0, len(alphabets), (s, n)).astype(np.int32)
    sym = np.abs(np.round(rng.laplace(0, scale, (s, n)))).astype(np.int32)
    sym[rng.rand(s, n) < 0.05] *= -1
    if name == "extremes":
        vals = [-2 ** 31, 2 ** 31 - 1, -(2 ** 20), 2 ** 20 + 3, 2 ** 30,
                -(2 ** 31 - 1), 2 ** 31 - 2, -1]
        sym[:, 3] = vals
    return ragged, sym, idx


def _corrupt(kind, buf, lens, rng):
    buf, lens = buf.copy(), lens.copy()
    if kind == "truncated":
        lens = lens // 2
    elif kind == "bitflip":
        for s in range(buf.shape[0]):
            buf[s, rng.randint(max(int(lens[s]), 1))] ^= np.uint8(
                1 << rng.randint(8))
    elif kind == "flips4":
        # tests/test_corrupt.py's flips: anywhere in the padded buffer.
        for _ in range(4):
            buf[rng.randint(buf.shape[0]), rng.randint(buf.shape[1])] ^= \
                np.uint8(1 << rng.randint(8))
    elif kind == "random":
        buf = rng.randint(0, 256, buf.shape).astype(np.uint8)
    elif kind == "empty":
        lens = np.zeros_like(lens)
    elif kind == "tiny":
        buf[:, :3] = 0xFF
        lens = np.minimum(lens, 3)
    cols = np.arange(buf.shape[1])[None, :]
    return np.where(cols < lens[:, None], buf, 0).astype(np.uint8), lens


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_warp_decoder_matches_jax_decode_streams(name, kind):
    """Streams encoded by the JAX package decode through the plain decoder
    built on the warp search to the JAX package's decode_streams symbols
    and sanity flags, and to decode_gamma_plain's."""
    ragged, sym, idx = _stream_case(name)
    rng = np.random.RandomState(CORRUPTIONS.index(kind))
    jt = jax_tables.parse_ragged_cdf(ragged)
    buf, lens = jax_coder.encode_streams(sym, jt, idx)
    buf, lens = _corrupt(kind, np.asarray(buf), np.asarray(lens), rng)
    ref, ref_ok = jax_coder.decode_streams(buf, lens, sym.shape[1], jt, idx)
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    cdf, meta = table.indexed_arrays()
    args = (torch.as_tensor(buf), torch.as_tensor(lens), torch.as_tensor(idx),
            cdf, meta)
    mine, ok = cuda_coder.decode_gamma_warp(*args, table.warp_arrays())
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    plain, plain_ok = cuda_coder.decode_gamma_thread(*args)
    assert torch.equal(mine, plain) and torch.equal(ok, plain_ok)
    if kind == "none":
        ovf = np.asarray(jt.overflow)[idx]
        # INT32_MIN's magnitude needs a 32nd gamma bit, which the format
        # does not have: its stream decodes to other values from there on.
        whole = ~(sym == -2 ** 31).any(1)
        keeps = ovf & whole[:, None]
        np.testing.assert_array_equal(mine.numpy()[keeps], sym[keeps])
        assert bool(ok.numpy()[whole].all())


@pytest.mark.parametrize("byte_len", [0, 1, 2, 3, 41])
def test_warp_decoder_short_and_odd_buffers(byte_len):
    """Streams of 0, 1, 2, 3 bytes and one as long as an odd buffer width:
    bytes at or past the length read as zero, whatever the buffer holds."""
    ragged, sym, idx = _stream_case("short_rows")
    rng = np.random.RandomState(byte_len)
    jt = jax_tables.parse_ragged_cdf(ragged)
    buf = rng.randint(0, 256, (sym.shape[0], 41)).astype(np.uint8)
    lens = np.full(sym.shape[0], byte_len, np.int32)
    zeroed = np.where(np.arange(41)[None, :] < byte_len, buf, 0).astype(
        np.uint8)
    ref, ref_ok = jax_coder.decode_streams(zeroed, lens, sym.shape[1], jt,
                                           idx)
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    mine, ok = cuda_coder.decode_gamma_warp(
        torch.as_tensor(buf), torch.as_tensor(lens), torch.as_tensor(idx),
        *table.indexed_arrays())
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))


@pytest.mark.parametrize("streams,variant", [(3, "warp"), (4, "warp"),
                                             (5, "thread")])
def test_variant_follows_the_stream_count(monkeypatch, streams, variant):
    """decode_gamma picks its variant from the number of streams alone:
    at most WARP_DECODE_MAX_STREAMS take the warp variant.  Both give the
    same symbols through the front end."""
    ragged, sym, idx = _stream_case("short_rows")
    reps = -(-streams // sym.shape[0])
    sym, idx = np.tile(sym, (reps, 1))[:streams], np.tile(idx, (reps, 1))[
        :streams]
    took = []
    for fn in ("decode_gamma_warp_plain", "decode_gamma_plain"):
        orig = getattr(cuda_coder, fn)

        def spy(*args, _orig=orig, _fn=fn):
            took.append(_fn)
            return _orig(*args)

        monkeypatch.setattr(cuda_coder, fn, spy)
    monkeypatch.setattr(cuda_coder, "WARP_DECODE_MAX_STREAMS", 4)
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    buf, lens = torch_coder.encode_streams(torch.as_tensor(sym), table,
                                           torch.as_tensor(idx))
    out, ok = torch_coder.decode_streams(buf, lens, sym.shape[1], table,
                                         torch.as_tensor(idx))
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    assert took == ["decode_gamma_warp_plain" if variant == "warp"
                    else "decode_gamma_plain"]
    ovf = np.asarray(table.host.overflow)[idx]
    np.testing.assert_array_equal(out.numpy()[ovf], sym[ovf])
    assert bool(ok.all())
    assert cuda_coder.LAUNCHES_WARP["decode_gamma"] == 0  # no kernel here


def test_layout_of_another_table_is_refused():
    ragged, sym, idx = _stream_case("short_rows")
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    cdf, meta = table.indexed_arrays()
    args = (torch.zeros((1, 8), dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32), cdf, meta)
    with pytest.raises(ValueError, match="layout"):
        cuda_coder.decode_gamma_warp(*args, table.warp_arrays()[:-8])
    with pytest.raises(ValueError, match="layout"):
        cuda_coder.decode_gamma_warp(*args, table.warp_arrays().int())


# -- K7' at element counts that are not multiples of four -------------------
@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (1, 5), (3, 7), (2, 6),
                                   (1, 4099)])
def test_pair_lookup_any_element_count(shape):
    rng = np.random.RandomState(sum(shape))
    flat = torch.as_tensor(rng.randint(0, 65537, 977).astype(np.int32))
    idx = torch.as_tensor(rng.randint(0, 976, shape).astype(np.int32))
    lo, hi = cuda_coder.pair_lookup(flat, idx)
    ref_lo, ref_hi = cuda_coder.pair_lookup_plain(flat, idx)
    assert lo.shape == idx.shape and hi.shape == idx.shape
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    assert torch.equal(lo, ref_lo) and torch.equal(hi, ref_hi)
    np.testing.assert_array_equal(lo.numpy(), flat.numpy()[idx.numpy()])
    np.testing.assert_array_equal(hi.numpy(), flat.numpy()[idx.numpy() + 1])
