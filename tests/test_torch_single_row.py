"""The single-row coder pair on the CPU: K5''s slot table and slot search
(``single_row_slots``, ``single_row_threshold_plain`` and the plain mirror
``decode_single_row_slot_plain``, which ``decode_single_row`` runs on the
CPU) and K4''s 32-bit chain (``encode_single_row_chain_plain``, which
``encode_single_row`` runs on the CPU) against the JAX package's single-row
decode and encode (``jax_coder.decode_streams`` / ``encode_streams`` and
the body of the TPU kernel ``pallas_coder.decode_scan_pallas_v2``),
the reference coder's golden bytes, and the plain versions of the parent
kernels, ``decode_single_row_plain`` / ``encode_single_row_plain``.

Inputs come from seeded numpy.  Every comparison is exact: symbols, sanity
flags, bytes and lengths are integers.
"""

import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder, pallas_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from test_pallas_decode import _FakeRef
from test_torch_reference_coder import (CORRUPTIONS, GOLDEN, GOLDEN_SUBSET,
                                        _corrupt)

torch.set_num_threads(1)

STREAMS, SYMBOLS = 16, 40


def _zipf(alphabet, precision):
    pmf = 1.0 / (1 + np.arange(alphabet)) ** 1.2
    pmf /= pmf.sum()
    return jax_tables.pmf_to_quantized_cdf(pmf, precision), pmf


# name -> (one CDF row, precision).  The zipf rows at precisions 1 to 16
# (the micro-bench's is zipf_p12: 256 symbols at precision 12), and rows
# with flat runs: symbols of probability zero.
ROWS = {f"zipf_p{p}": (_zipf(min(256, 2 ** p), p)[0], p)
        for p in (1, 8, 12, 14, 15, 16)}
ROWS["flat_p12"] = (np.array([0, 100, 100, 100, 2000, 2000, 4095, 4096]), 12)
ROWS["flat_p16"] = (np.array([0, 1, 1, 30000, 30000, 65535, 65536]), 16)
ROWS["flat_head_p8"] = (np.array([0, 0, 0, 7, 255, 256]), 8)


def _tables(name):
    row, prec = ROWS[name]
    ragged = jax_tables.build_ragged_cdf([row], [prec], [False])
    return (jax_tables.parse_ragged_cdf(ragged),
            torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                       "cpu"))


def _symbols(name, rng, shape=(STREAMS, SYMBOLS)):
    """Symbols of the row's nonzero probabilities, and out-of-range values
    that the encode clips (where the ends they clip to are live)."""
    row, _ = ROWS[name]
    live = [v for v in range(len(row) - 1) if row[v + 1] > row[v]]
    p = np.diff(np.asarray(row, np.float64))[live]
    sym = rng.choice(live, size=shape, p=p / p.sum()).astype(np.int32)
    if sym.size >= 4 and {0, len(row) - 2} <= set(live):
        sym.reshape(-1)[:4] = [-5, len(row) + 3, -2 ** 31, 2 ** 31 - 1]
    return sym


def _counts_over_row(row, t):
    """Entries k in [1, len) of the row below each t."""
    return (np.asarray(row[1:], np.int64)[None, :]
            < np.asarray(t, np.int64)[:, None]).sum(1)


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("pad", [0, 5])
def test_slot_table_entry_for_entry(name, pad):
    """Every slot of single_row_slots against a count over the row (padded
    with its terminal value as a dense table's rows are): the symbol
    min(count, L - 2) and the interval [row[count], row[count + 1]) (65536
    past the row); at precision 15 and 16 the count, and slot 2^prec + 1's
    as the kernel takes it, L - 1."""
    row, prec = ROWS[name]
    row = np.concatenate([row, np.full(pad, row[-1])]).astype(np.int32)
    cdf = torch.as_tensor(row[None])
    meta = torch.tensor([[len(row) - 2, prec, 0]], dtype=torch.int32)
    slots = cuda_coder.single_row_slots(cdf, meta)
    assert slots[1] == prec
    assert slots[0].dtype == torch.int32
    assert slots[0].numel() % 4 == 0
    search = cuda_coder._SlotSearch(slots, len(row))
    tmax = (1 << prec) + 1
    t = torch.arange(1, tmax + 1)
    sym, c_lo, c_hi = (v.numpy() for v in search(t))
    count = _counts_over_row(row, t.numpy())
    np.testing.assert_array_equal(sym, np.minimum(count, len(row) - 2))
    np.testing.assert_array_equal(c_lo, row[count])
    padded = np.concatenate([row, [65536]])
    np.testing.assert_array_equal(c_hi, padded[count + 1])
    if prec > cuda_coder.SLOT_PAIR_MAX_PRECISION:
        counts = slots[0][: (tmax + 1) // 2].view(torch.int16).long() & 0xFFFF
        want = np.minimum(_counts_over_row(row, np.arange(tmax + 1)), 65535)
        np.testing.assert_array_equal(counts.numpy(), want)


def test_slot_table_refuses_outside_its_domain():
    row = torch.as_tensor(np.arange(0, 65539, dtype=np.int32)[None])
    with pytest.raises(ValueError):
        cuda_coder.single_row_slots(row, None, precision=16)
    with pytest.raises(ValueError):
        cuda_coder.single_row_slots(row[:, :10], None, precision=17)
    _, table = _tables("zipf_p12")
    cdf, meta = table.indexed_arrays()
    slots, prec = table.single_row_slots()
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_coder.decode_single_row(buf, torch.zeros(2, dtype=torch.int32),
                                     4, cdf, meta, (slots[:-4], prec))


@pytest.mark.parametrize("precision", [1, 2, 8, 12, 14, 15, 16])
def test_threshold_is_exact(precision):
    """The slot index from the f32 quotient and its fix-up equals the exact
    min(ceil((offset + 1) 2^prec / (sm1 + 1)), 2^prec + 1): random states,
    the first step (size 2^32), offsets at and past the range's end (a
    corrupt stream) and every quotient within one of an integer."""
    rng = np.random.RandomState(precision)
    m32 = 0xFFFFFFFF
    sm1 = rng.randint(0xFFFF, m32, 4000, dtype=np.int64)
    offset = (rng.rand(4000) * (sm1 + 1)).astype(np.int64)
    sm1 = np.concatenate([sm1, [m32] * 6, [0xFFFF] * 6, sm1[:200],
                          sm1[:200]])
    offset = np.concatenate([
        offset, [0, 1, m32, m32 - 1, 1 << 31, 12345], [0, 0xFFFF, 0x10000,
                                                       m32, 0xFFFE, 7],
        sm1[4012:4212], np.minimum(sm1[4012:4212] + 5, m32)])
    # States whose quotient lands on an integer k or just beside it.
    k = rng.randint(1, (1 << precision) + 1, 400)
    s2 = rng.randint(0xFFFF, m32, 400, dtype=np.int64) + 1
    on = (k * s2 >> precision) - 1
    sm1 = np.concatenate([sm1, s2 - 1, s2 - 1, s2 - 1])
    offset = np.concatenate([offset, np.clip(on, 0, m32),
                             np.clip(on + 1, 0, m32), np.clip(on - 1, 0,
                                                              m32)])
    t = cuda_coder.single_row_threshold_plain(
        torch.as_tensor(offset), torch.as_tensor(sm1), precision).numpy()
    lb = [(int(o) + 1) << precision for o in offset]
    exact = [min(-(-a // (int(s) + 1)), (1 << precision) + 1)
             for a, s in zip(lb, sm1)]
    np.testing.assert_array_equal(t, exact)


def _jax_decode(jt, buf, lens, n):
    sym, ok = jax_coder.decode_streams(buf, lens, n, jt)
    return np.asarray(sym), np.asarray(ok)


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_decode_matches_jax(name, kind):
    """decode_single_row on the CPU (the slot-search mirror) ==
    jax_coder.decode_streams' single-row decode == the parent's plain
    version: symbols and sanity flags, intact and corrupt streams."""
    jt, table = _tables(name)
    rng = np.random.RandomState(sorted(ROWS).index(name) * 7
                                + CORRUPTIONS.index(kind))
    sym = _symbols(name, rng)
    buf, lens = jax_coder.encode_streams(sym, jt)
    buf, lens = _corrupt(kind, buf, lens, rng)
    ref, ref_ok = _jax_decode(jt, buf, lens, SYMBOLS)
    cdf, meta = table.indexed_arrays()
    args = (torch.as_tensor(buf), torch.as_tensor(lens), SYMBOLS, cdf, meta)
    mine, ok = cuda_coder.decode_single_row(*args, table.single_row_slots())
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    plain, plain_ok = torch.empty_like(mine), torch.empty_like(ok)
    cuda_coder.decode_single_row_plain(*args[:2], cdf, meta, plain, plain_ok)
    assert torch.equal(plain, mine) and torch.equal(plain_ok, ok)
    if kind == "none":
        np.testing.assert_array_equal(
            ref, np.clip(sym, 0, len(ROWS[name][0]) - 2))
        assert ok.all()


@pytest.mark.parametrize("extra", [1, 3, 4, 12, -40])
def test_decode_odd_and_unaligned_widths(extra):
    """Buffers of odd width, of widths that are a multiple of 4 but not of
    16, and one narrower than the streams (bytes past the width read as
    zero): the mirror == JAX."""
    jt, table = _tables("zipf_p12")
    rng = np.random.RandomState(extra + 50)
    sym = _symbols("zipf_p12", rng)
    buf, lens = jax_coder.encode_streams(sym, jt)
    width = buf.shape[1] + extra
    wide = np.zeros((STREAMS, width), np.uint8)
    wide[:, : min(width, buf.shape[1])] = buf[:, :width]
    ref, ref_ok = _jax_decode(jt, wide, lens, SYMBOLS)
    cdf, meta = table.indexed_arrays()
    mine, ok = cuda_coder.decode_single_row(
        torch.as_tensor(wide), torch.as_tensor(lens), SYMBOLS, cdf, meta)
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    if extra > 0:
        assert ok.all()


@pytest.mark.parametrize("n", [0, 1, 3])
def test_empty_and_short_streams(n):
    """Streams of 0, 1 and 3 symbols, coded and decoded: the mirrors ==
    JAX, bytes, lengths, symbols and flags."""
    jt, table = _tables("zipf_p8")
    sym = _symbols("zipf_p8", np.random.RandomState(n), (5, n))
    buf, lens = jax_coder.encode_streams(sym, jt)
    mine, mine_lens = torch_coder.encode_streams(torch.as_tensor(sym), table)
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    ref, ref_ok = _jax_decode(jt, buf, lens, n)
    got, ok = torch_coder.decode_streams(mine, mine_lens, n, table)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-single"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)


def test_decode_matches_pallas_v2_kernel(monkeypatch):
    """The mirror == the TPU kernel it replaces, decode_scan_pallas_v2's
    body (_make_decode_kernel_v2), on 128 streams of the micro-bench's row,
    one of them truncated and one bit-flipped.  The body runs eagerly
    through fake refs, as tests/test_pallas_decode.py runs it (interpret
    mode is far too slow for it)."""
    def eager_fori(lo, hi, body, init):
        carry = init
        for i in range(int(lo), int(hi)):
            carry = body(i, carry)
        return carry

    monkeypatch.setattr(pallas_coder.jax.lax, "fori_loop", eager_fori)
    jt, table = _tables("zipf_p12")
    rng = np.random.RandomState(9)
    n = 24
    sym = _symbols("zipf_p12", rng, (128, n))
    buf, lens = (np.array(a) for a in jax_coder.encode_streams(sym, jt))
    lens[1] //= 2
    buf[2, 3] ^= 0x20
    buf = np.where(np.arange(buf.shape[1])[None] < lens[:, None], buf, 0
                   ).astype(np.uint8)
    src16 = np.asarray(jax_coder.bytes_to_chunks(buf, lens))
    cdf_row = np.asarray(jt.cdf[0])
    blast, win = pallas_coder._decode_v2_tables(cdf_row)
    nchunks = src16.shape[1]
    nb_pull = max((nchunks + 16) // 16, 1) + 1
    src_t = np.zeros((16 * nb_pull + 32, 1, 128), np.int32)
    src_t[:nchunks, 0] = src16.astype(np.uint32).astype(np.int64).T
    kernel = pallas_coder._make_decode_kernel_v2(
        n, 12, len(cdf_row) - 1, win.shape[1] // 17, nb_pull, 1)
    ref = np.zeros((n, 1, 128), np.int32)
    ref_ok = np.zeros((1, 128), np.int32)
    kernel(_FakeRef(src_t), _FakeRef(lens.reshape(1, 128)), _FakeRef(blast),
           _FakeRef(win), _FakeRef(ref), _FakeRef(ref_ok))
    cdf, meta = table.indexed_arrays()
    mine, ok = cuda_coder.decode_single_row(
        torch.as_tensor(buf), torch.as_tensor(lens), n, cdf, meta)
    np.testing.assert_array_equal(mine.numpy(), ref[:, 0].T)
    np.testing.assert_array_equal(ok.numpy(), ref_ok[0] != 0)
    assert ok[3:].all()


@pytest.mark.parametrize("name", sorted(ROWS))
def test_encode_chain_matches_jax(name):
    """encode_single_row on the CPU (the 32-bit chain's mirror) ==
    jax_coder.encode_streams == the parent's plain version, clipped values
    included; the chain serves every row here, since the symbols of
    probability zero are not coded."""
    jt, table = _tables(name)
    rng = np.random.RandomState(sorted(ROWS).index(name) + 70)
    sym = _symbols(name, rng)
    buf, lens = jax_coder.encode_streams(sym, jt)
    cdf, meta = table.indexed_arrays()
    t = torch.as_tensor(sym)
    mine, mine_lens = cuda_coder.encode_single_row(t, cdf, meta,
                                                   buf.shape[1])
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    plain, plain_lens = torch.empty_like(mine), torch.empty_like(mine_lens)
    cuda_coder.encode_single_row_plain(t, cdf, meta, plain, plain_lens)
    assert torch.equal(plain, mine) and torch.equal(plain_lens, mine_lens)


def test_encode_zero_probability_symbols_take_the_reference():
    """A row whose coded symbols include ones of probability zero is not
    the chain's (an empty interval): the mirror takes the reference
    recurrence, as the kernel does, and equals JAX."""
    jt, table = _tables("flat_p12")
    cdf, meta = table.indexed_arrays()
    rng = np.random.RandomState(3)
    sym = rng.randint(0, len(ROWS["flat_p12"][0]) - 1,
                      (STREAMS, SYMBOLS)).astype(np.int32)
    buf, lens = jax_coder.encode_streams(sym, jt)
    mine, mine_lens = cuda_coder.encode_single_row(
        torch.as_tensor(sym), cdf, meta, buf.shape[1])
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)


@pytest.mark.parametrize("name", GOLDEN_SUBSET)
def test_encode_chain_golden_bytes(name):
    """golden.npz cases through the 32-bit chain's mirror: the reference
    C++ coder's bytes (carry_p16's long delayed-carry groups, the short
    streams, precisions 1 to 16)."""
    gold = np.load(GOLDEN)
    data = gold[f"{name}__data"].astype(np.int32)[None]
    prec = int(gold[f"{name}__precision"])
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf([gold[f"{name}__cdf"]], [prec], [False])),
        "cpu")
    cdf, meta = table.indexed_arrays()
    assert cuda_coder._chain_serves_row(cdf, meta)
    out = torch.empty((1, torch_coder.stream_out_size(data.shape[1])),
                      dtype=torch.uint8)
    length = torch.empty((1,), dtype=torch.int32)
    cuda_coder.encode_single_row_chain_plain(torch.as_tensor(data), cdf, meta,
                                             out, length)
    assert out[0, : int(length[0])].numpy().tobytes() == \
        gold[f"{name}__bytes"].tobytes()
    assert not out[0, int(length[0]):].any()


def test_decode_streams_keeps_the_slot_table():
    """decode_streams' single-row route hands the table's cached slot table
    down: built once per DeviceCdfTable, from the host's precision."""
    jt, table = _tables("zipf_p12")
    sym = _symbols("zipf_p12", np.random.RandomState(4))
    buf, lens = torch_coder.encode_streams(torch.as_tensor(sym), table)
    got, ok = torch_coder.decode_streams(buf, lens, SYMBOLS, table)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-single"
    first = table.kernel_tables["single_row"]
    assert table.single_row_slots() is first and first[1] == 12
    torch_coder.decode_streams(buf, lens, SYMBOLS, table)
    assert table.kernel_tables["single_row"] is first
    np.testing.assert_array_equal(got.numpy(), np.clip(sym, 0, 255))
    assert ok.all()
