"""CUDA kernels of compression_tpu_torch against their plain versions.

These need an NVIDIA GPU and skip elsewhere (a CUDA kernel has no CPU
mode); on a machine with one, run
``python -m pytest tests/test_torch_cuda.py`` (chip_smoke.py drives the
same comparisons at full size)."""

import os
import re

import numpy as np
import pytest
import torch

from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from scan_cases import (as_tensors, limit_micro_ops, long_carry_ops,
                        valid_micro_ops)
from symbol_cases import SYMBOL_CASES, short_row_case, symbol_case

pytestmark = pytest.mark.cuda


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    cuda_coder.build()
    return torch.device("cuda")


def _table(seed, overflow, device):
    rng = np.random.RandomState(seed)
    cdfs, precs = [], []
    for _ in range(8):
        prec = int(rng.randint(8, 17))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, 40))))
        cdfs.append(tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    ragged = tables.build_ragged_cdf(cdfs, precs, [overflow] * 8)
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                      device)


@pytest.mark.parametrize("overflow", [False, True])
def test_kernels_match_plain(device, overflow):
    table = _table(int(overflow), overflow, device)
    cdf, meta = table.indexed_arrays()
    gen = torch.Generator(device=device).manual_seed(0)
    idx = torch.randint(0, 8, (300, 77), generator=gen, device=device,
                        dtype=torch.int32)
    sym = torch.randint(-3, 45, (300, 77), generator=gen, device=device,
                        dtype=torch.int32)
    out_size = torch_coder.stream_out_size(77)
    before = dict(cuda_coder.LAUNCHES)
    buf, lens = cuda_coder.encode_indexed(sym, idx, cdf, meta, out_size)
    ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_indexed_plain(sym, idx, cdf, meta, ref_buf, ref_lens)
    assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
    out, ok = cuda_coder.decode_indexed(buf, lens, idx, cdf, meta)
    ref_out, ref_ok = torch.empty_like(out), torch.empty_like(ok)
    cuda_coder.decode_indexed_plain(buf, lens, idx, cdf, meta, ref_out,
                                    ref_ok)
    assert torch.equal(out, ref_out) and torch.equal(ok, ref_ok)
    assert bool(ok.all())
    assert cuda_coder.LAUNCHES["encode_indexed"] == before[
        "encode_indexed"] + 1
    assert cuda_coder.LAUNCHES["decode_indexed"] == before[
        "decode_indexed"] + 1


def _launched(name, before):
    return cuda_coder.LAUNCHES[name] == before[name] + 1


def test_single_row_kernels_match_plain(device):
    """K4' and K5' against their plain versions, out-of-range symbols and
    a corrupt stream included."""
    rng = np.random.RandomState(2)
    pmf = 1.0 / (1 + np.arange(256)) ** 1.2
    pmf /= pmf.sum()
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf([tables.pmf_to_quantized_cdf(pmf, 12)],
                                [12], [False])), device)
    cdf, meta = table.indexed_arrays()
    sym = rng.choice(256, size=(300, 64), p=pmf).astype(np.int32)
    sym[0, :3] = [-4, 300, 2 ** 31 - 1]
    sym = torch.as_tensor(sym, device=device)
    out_size = torch_coder.stream_out_size(64)
    before = dict(cuda_coder.LAUNCHES)
    buf, lens = cuda_coder.encode_single_row(sym, cdf, meta, out_size)
    ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_single_row_plain(sym, cdf, meta, ref_buf, ref_lens)
    assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
    assert _launched("encode_single_row", before)
    lens[1] //= 2  # a truncated stream
    out, ok = cuda_coder.decode_single_row(buf, lens, 64, cdf, meta)
    ref_out, ref_ok = torch.empty_like(out), torch.empty_like(ok)
    cuda_coder.decode_single_row_plain(buf, lens, cdf, meta, ref_out, ref_ok)
    assert torch.equal(out, ref_out) and torch.equal(ok, ref_ok)
    assert _launched("decode_single_row", before)
    assert bool(ok[2:].all())


def _single_row_table(cdf_row, precision, device):
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf([np.asarray(cdf_row)], [precision], [False])),
        device)


def _single_row_pair_matches_plain(table, sym, widths):
    """K4' at each output width (rows at even, odd and 4-byte aligned
    addresses) and K5' on buffers of each width holding those bytes,
    truncated and bit-flipped streams included, against the plain
    versions; the table's cached slot table and one built on the call."""
    cdf, meta = table.indexed_arrays()
    n = int(sym.shape[1])
    out_size = torch_coder.stream_out_size(n)
    for width in (out_size, out_size + 1, out_size + 2):
        before = dict(cuda_coder.LAUNCHES)
        buf, lens = cuda_coder.encode_single_row(sym, cdf, meta, width)
        assert _launched("encode_single_row", before)
        ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
        cuda_coder.encode_single_row_plain(sym, cdf, meta, ref_buf, ref_lens)
        assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
    buf, lens = ref_buf[:, :out_size].contiguous(), ref_lens.clone()
    lens[1] //= 2
    buf[2, 5] ^= 0x10
    for width in widths:
        b = torch.zeros((buf.shape[0], width), dtype=torch.uint8,
                        device=buf.device)
        w = min(width, out_size)
        b[:, :w] = buf[:, :w]
        ln = lens.clamp(max=width)
        ref, ref_ok = torch.empty_like(sym), torch.empty(
            sym.shape[0], dtype=torch.bool, device=sym.device)
        cuda_coder.decode_single_row_plain(b, ln, cdf, meta, ref, ref_ok)
        for slots in (table.single_row_slots(), None):
            before = dict(cuda_coder.LAUNCHES)
            out, ok = cuda_coder.decode_single_row(b, ln, n, cdf, meta, slots)
            assert _launched("decode_single_row", before)
            assert torch.equal(out, ref) and torch.equal(ok, ref_ok), width


@pytest.mark.parametrize("precision", [1, 8, 12, 14, 15, 16])
def test_single_row_pair_any_precision_and_width(device, precision):
    """K4' and K5' at every precision (K5''s slot table with the pair up to
    14, counts above), rows of even, odd and 4-byte aligned widths, and
    buffers shorter than 16 bytes."""
    rng = np.random.RandomState(precision)
    k = min(256, 2 ** precision)
    pmf = 1.0 / (1 + np.arange(k)) ** 1.2
    pmf /= pmf.sum()
    table = _single_row_table(tables.pmf_to_quantized_cdf(pmf, precision),
                              precision, device)
    sym = torch.as_tensor(rng.choice(k, size=(300, 77), p=pmf).astype(
        np.int32), device=device)
    sym[0, :3] = torch.tensor([-4, k + 5, 2 ** 31 - 1], dtype=torch.int32)
    out_size = torch_coder.stream_out_size(77)
    _single_row_pair_matches_plain(
        table, sym, (out_size, out_size + 1, out_size + 2, out_size + 4, 9))


@pytest.mark.parametrize("entries", [30000, 60000])
def test_single_row_pair_long_rows(device, entries):
    """A precision-16 row of 30000 entries (K5''s counts and row past
    shared memory: read from global memory) and of 60000 (K4''s packed
    pairs too)."""
    rng = np.random.RandomState(entries)
    pmf = rng.dirichlet(np.ones(entries - 1))
    table = _single_row_table(tables.pmf_to_quantized_cdf(pmf, 16), 16,
                              device)
    sym = torch.as_tensor(rng.randint(0, entries - 1, (300, 64)).astype(
        np.int32), device=device)
    _single_row_pair_matches_plain(table, sym, (
        torch_coder.stream_out_size(64), torch_coder.stream_out_size(64) + 1))


@pytest.mark.parametrize("precision", [12, 16])
def test_single_row_pair_zero_probability_symbols(device, precision):
    """A row with flat runs (symbols of probability zero): K5''s slot table
    counts them as the row does; K4' codes the others on its chain, and at
    precision 12 a stream holding them by the reference recurrence."""
    row = {12: [0, 100, 100, 100, 2000, 2000, 4095, 4096],
           16: [0, 1, 1, 30000, 30000, 65535, 65536]}[precision]
    table = _single_row_table(row, precision, device)
    rng = np.random.RandomState(precision)
    live = [v for v in range(len(row) - 1) if row[v + 1] > row[v]]
    sym = torch.as_tensor(rng.choice(live, size=(300, 77)).astype(np.int32),
                          device=device)
    out_size = torch_coder.stream_out_size(77)
    _single_row_pair_matches_plain(table, sym, (out_size, out_size + 1))
    if precision == 12:
        cdf, meta = table.indexed_arrays()
        dead = sym.clone()
        dead[:, ::5] = 1
        buf, lens = cuda_coder.encode_single_row(dead, cdf, meta, out_size)
        ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
        cuda_coder.encode_single_row_plain(dead, cdf, meta, ref_buf, ref_lens)
        assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)


@pytest.mark.parametrize("n", [0, 1, 3, 17, 40])
def test_single_row_pair_short_streams(device, n):
    """Streams of 0 to 40 symbols (no full window, a partial period), rows
    at odd addresses."""
    rng = np.random.RandomState(n)
    pmf = 1.0 / (1 + np.arange(40)) ** 1.2
    pmf /= pmf.sum()
    table = _single_row_table(tables.pmf_to_quantized_cdf(pmf, 11), 11,
                              device)
    sym = torch.as_tensor(rng.choice(40, size=(37, n), p=pmf).astype(
        np.int32), device=device)
    out_size = torch_coder.stream_out_size(n)
    _single_row_pair_matches_plain(table, sym, (out_size, out_size + 3))


def test_gamma_kernels_match_plain(device):
    """K6' and K3' against their plain versions on escapes of every size,
    the INT32 extremes included."""
    table = _table(3, True, device)
    cdf, meta = table.indexed_arrays()
    rng = np.random.RandomState(3)
    idx = torch.as_tensor(rng.randint(0, 8, (200, 50)), dtype=torch.int32,
                          device=device)
    sym = np.round(rng.laplace(0, 30, (200, 50))).astype(np.int32)
    sym[:6, 0] = [-2 ** 31, 2 ** 31 - 1, 2 ** 20, -2 ** 20, 2 ** 30, -1]
    sym = torch.as_tensor(sym, device=device)
    counts, _, _, _ = cuda_coder.interval_counts(sym, idx, meta)
    out_size = torch_coder.stream_out_size(int(counts.sum(1).max()))
    before = dict(cuda_coder.LAUNCHES)
    buf, lens = cuda_coder.encode_gamma(sym, idx, cdf, meta, out_size)
    ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_gamma_plain(sym, idx, cdf, meta, ref_buf, ref_lens)
    assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
    assert _launched("encode_gamma", before)
    out, ok = cuda_coder.decode_gamma(buf, lens, idx, cdf, meta)
    ref_out, ref_ok = torch.empty_like(out), torch.empty_like(ok)
    cuda_coder.decode_gamma_plain(buf, lens, idx, cdf, meta, ref_out, ref_ok)
    assert torch.equal(out, ref_out) and torch.equal(ok, ref_ok)
    assert _launched("decode_gamma", before)
    assert bool(ok[2:].all())


@pytest.mark.parametrize("big", [False, True])
def test_pair_lookup_matches_plain(device, big):
    """K7' against its plain version on a small and a large table,
    clamped indices included."""
    gen = torch.Generator(device=device).manual_seed(4)
    k = 70000 if big else 3000
    flat = torch.randint(0, 2 ** 16, (k,), generator=gen, device=device,
                         dtype=torch.int32)
    idx = torch.randint(0, k - 1, (37, 1001), generator=gen, device=device,
                        dtype=torch.int32)
    idx[0, :4] = torch.tensor([-5, k - 1, k + 9, 0], dtype=torch.int32)
    before = dict(cuda_coder.LAUNCHES)
    lo, hi = cuda_coder.pair_lookup(flat, idx)
    ref_lo, ref_hi = cuda_coder.pair_lookup_plain(flat, idx)
    assert torch.equal(lo, ref_lo) and torch.equal(hi, ref_hi)
    assert _launched("pair_lookup", before)


def test_micro_op_route_matches_plain(device):
    """The micro-op encode mode against its plain version and against K6'
    (symbol mode) on the same data; the expansion through K7' equals the
    one through the plain lookup; the static budget copies nothing to the
    host."""
    table = _table(5, True, device)
    cdf, meta = table.indexed_arrays()
    rng = np.random.RandomState(5)
    idx = torch.as_tensor(rng.randint(0, 8, (200, 50)), dtype=torch.int32,
                          device=device)
    sym = np.round(rng.laplace(0, 30, (200, 50))).astype(np.int32)
    sym[:4, 0] = [2 ** 15, -2 ** 15, 2 ** 16 - 100, -1]
    sym = torch.as_tensor(sym, device=device)
    slots, num_steps = 35, 50 + 50 * 35
    out_size = 2 * num_steps + 4
    before = dict(cuda_coder.LAUNCHES)
    before_warp = cuda_coder.LAUNCHES_WARP["encode_scan"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops = torch_coder.micro_ops_from_symbols(sym, idx, table, slots,
                                                 num_steps)
        buf, lens = torch_coder.encode_core(*ops, out_size)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launched("pair_lookup", before)
    assert _launched("encode_scan", before)
    # 200 streams: the warp-per-stream kernel.
    assert cuda_coder.LAUNCHES_WARP["encode_scan"] == before_warp + 1
    assert torch_coder.DISPATCH_LOG["encode"] == "cuda-micro"
    plain_ops = cuda_coder.gamma_micro_ops(sym, idx, cdf, meta, num_steps,
                                           slots)
    for a, b in zip(ops, plain_ops):
        assert torch.equal(a, b)
    ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_scan_plain(*ops, ref_buf, ref_lens)
    assert torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
    gbuf, glens = cuda_coder.encode_gamma(sym, idx, cdf, meta, out_size)
    assert torch.equal(buf, gbuf) and torch.equal(lens, glens)
    out, ok = cuda_coder.decode_gamma(buf, lens, idx, cdf, meta)
    assert torch.equal(out, sym) and bool(ok.all())


@pytest.mark.parametrize("precision", [12, 16])
def test_bucketed_decode_matches_plain(device, precision):
    """K8' against its plain version and against K5', a truncated and a
    bit-flipped stream included."""
    rng = np.random.RandomState(precision)
    pmf = 1.0 / (1 + np.arange(256)) ** 1.2
    pmf /= pmf.sum()
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf(
            [tables.pmf_to_quantized_cdf(pmf, precision)], [precision],
            [False])), device)
    cdf, meta = table.indexed_arrays()
    sym = torch.as_tensor(
        rng.choice(256, size=(300, 64), p=pmf).astype(np.int32),
        device=device)
    buf, lens = cuda_coder.encode_single_row(
        sym, cdf, meta, torch_coder.stream_out_size(64))
    lens[1] //= 2
    buf[2, 5] ^= 0x10
    before = dict(cuda_coder.LAUNCHES)
    bucketed = table.bucketed_arrays()
    out, ok = cuda_coder.decode_single_row_bucketed(buf, lens, 64, *bucketed)
    assert _launched("decode_single_row_bucketed", before)
    ref_out, ref_ok = torch.empty_like(out), torch.empty_like(ok)
    cuda_coder.decode_single_row_bucketed_plain(buf, lens, *bucketed,
                                                ref_out, ref_ok)
    assert torch.equal(out, ref_out) and torch.equal(ok, ref_ok)
    k5_out, k5_ok = cuda_coder.decode_single_row(buf, lens, 64, cdf, meta)
    assert torch.equal(out, k5_out) and torch.equal(ok, k5_ok)
    assert torch.equal(out[3:], sym[3:]) and bool(ok[3:].all())


def _long_row_table(device, num_rows, entries, seed):
    """Rows of up to ``entries`` entries at precision 16 (the two-level
    search), every other one shorter; all overflow rows."""
    rng = np.random.RandomState(seed)
    cdfs = [tables.pmf_to_quantized_cdf(
        rng.dirichlet(np.full(entries - 1 - 7 * (r % 2), 0.5)), 16)
        for r in range(num_rows)]
    ragged = tables.build_ragged_cdf(cdfs, [16] * num_rows, [True] * num_rows)
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                      device)


def _gamma_streams(table, device, streams, n, seed, scale):
    cdf, meta = table.indexed_arrays()
    rng = np.random.RandomState(seed)
    idx = torch.as_tensor(rng.randint(0, table.num_rows, (streams, n)),
                          dtype=torch.int32, device=device)
    sym = torch.as_tensor(
        np.round(rng.laplace(0, scale, (streams, n))).astype(np.int32),
        device=device)
    counts, _, _, _ = cuda_coder.interval_counts(sym, idx, meta)
    buf, lens = cuda_coder.encode_gamma(
        sym, idx, cdf, meta,
        torch_coder.stream_out_size(int(counts.sum(1).max())))
    return sym, idx, buf, lens


def _both_variants_match_plain(buf, lens, idx, table):
    """Both kernels of K3' against decode_gamma_plain, run once."""
    cdf, meta = table.indexed_arrays()
    before = (cuda_coder.LAUNCHES["decode_gamma"],
              cuda_coder.LAUNCHES_WARP["decode_gamma"])
    warp = cuda_coder.decode_gamma_warp(buf, lens, idx, cdf, meta,
                                        table.warp_arrays())
    thread = cuda_coder.decode_gamma_thread(buf, lens, idx, cdf, meta)
    torch.cuda.synchronize()
    assert (cuda_coder.LAUNCHES["decode_gamma"],
            cuda_coder.LAUNCHES_WARP["decode_gamma"]) == (
                before[0] + 2, before[1] + 1)
    ref = (torch.empty_like(warp[0]), torch.empty_like(warp[1]))
    cuda_coder.decode_gamma_plain(buf, lens, idx, cdf, meta, *ref)
    for got in (warp, thread):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return ref


# (rows, entries of the longest row): one-level search; two levels in shared
# memory; three coarse rounds; a layout too large for shared memory.
WARP_TABLES = {"short": None, "two_level": (6, 1481), "wide": (3, 2101),
               "global": (120, 1100)}


@pytest.mark.parametrize("name", sorted(WARP_TABLES))
def test_gamma_decode_variants_match_plain(device, name):
    """Both kernels of K3' on intact streams with escapes of every size
    (round trip included), truncated, bit-flipped, random and empty ones,
    on tables that take each path of the warp kernel's search."""
    table = _table(7, True, device) if WARP_TABLES[name] is None else \
        _long_row_table(device, *WARP_TABLES[name], seed=8)
    sym, idx, buf, lens = _gamma_streams(table, device, 70, 150, 9, 60.0)
    out, ok = _both_variants_match_plain(buf, lens, idx, table)
    assert torch.equal(out, sym) and bool(ok.all())
    gen = torch.Generator(device=device).manual_seed(10)
    cols = torch.arange(buf.shape[1], device=device)
    flipped = buf ^ ((torch.rand(buf.shape, generator=gen, device=device)
                      < 0.01).to(torch.uint8) * 4)
    noise = torch.randint(0, 256, buf.shape, generator=gen, device=device,
                          dtype=torch.uint8)
    for b, ln in ((buf, lens // 2), (flipped, lens), (noise, lens),
                  (buf, torch.zeros_like(lens))):
        b = torch.where(cols[None, :] < ln[:, None], b, 0).to(torch.uint8)
        _both_variants_match_plain(b.contiguous(), ln.contiguous(), idx,
                                   table)


@pytest.mark.parametrize("width", [41, 64, 1031])
def test_gamma_decode_variants_short_streams_and_odd_widths(device, width):
    """Streams of 0, 1, 2, 3 and ``width`` bytes in a buffer full of
    noise: bytes at or past each length read as zero; an odd width leaves
    most rows' starts unaligned, and 1031 bytes span three ring windows."""
    table = _table(11, True, device)
    gen = torch.Generator(device=device).manual_seed(width)
    buf = torch.randint(0, 256, (40, width), generator=gen, device=device,
                        dtype=torch.uint8)
    lens = torch.tensor([0, 1, 2, 3, width] * 8, dtype=torch.int32,
                        device=device)
    idx = torch.randint(0, 8, (40, 600), generator=gen, device=device,
                        dtype=torch.int32)
    _both_variants_match_plain(buf, lens, idx, table)
    # A view that starts one byte into its storage.
    flat = torch.randint(0, 256, (40 * width + 1,), generator=gen,
                         device=device, dtype=torch.uint8)
    _both_variants_match_plain(flat[1:].view(40, width), lens, idx, table)


def test_gamma_decode_variant_follows_the_stream_count(device):
    """decode_gamma takes the warp kernel up to WARP_DECODE_MAX_STREAMS
    streams and the thread kernel above."""
    table = _table(12, True, device)
    cdf, meta = table.indexed_arrays()
    edge = cuda_coder.WARP_DECODE_MAX_STREAMS
    sym, idx, buf, lens = _gamma_streams(table, device, edge + 1, 40, 13, 30.0)
    for streams, warp in ((edge, 1), (edge + 1, 0), (1, 1)):
        before = (cuda_coder.LAUNCHES["decode_gamma"],
                  cuda_coder.LAUNCHES_WARP["decode_gamma"])
        out, ok = torch_coder.decode_streams(
            buf[:streams].contiguous(), lens[:streams].contiguous(), 40,
            table, idx[:streams].contiguous())
        assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"
        assert (cuda_coder.LAUNCHES["decode_gamma"],
                cuda_coder.LAUNCHES_WARP["decode_gamma"]) == (
                    before[0] + 1, before[1] + warp)
        assert torch.equal(out, sym[:streams]) and bool(ok.all())


@pytest.mark.parametrize("count", [1, 3, 5, 4096, 196608, 196609])
def test_pair_lookup_any_element_count(device, count):
    """K7' where the count is no multiple of four (a scalar tail), and on
    indices that start 4 bytes into their storage (no 16-byte loads)."""
    gen = torch.Generator(device=device).manual_seed(count)
    flat = torch.randint(0, 2 ** 16, (94784,), generator=gen, device=device,
                         dtype=torch.int32)
    store = torch.randint(0, 94783, (count + 1,), generator=gen,
                          device=device, dtype=torch.int32)
    for idx in (store[:count].view(1, count), store[1:].view(1, count)):
        lo, hi = cuda_coder.pair_lookup(flat, idx)
        ref_lo, ref_hi = cuda_coder.pair_lookup_plain(flat, idx)
        assert torch.equal(lo, ref_lo) and torch.equal(hi, ref_hi)


def _both_kernels_match_plain(name, args, out_size, streams):
    """Both kernels of an encoder with two (K1, K6' or K6's micro-op mode:
    ``name``) and its wrapper against its plain version, run once; returns
    the plain result."""
    before = (cuda_coder.LAUNCHES[name], cuda_coder.LAUNCHES_WARP[name])
    got = [getattr(cuda_coder, name + "_warp")(*args, out_size),
           getattr(cuda_coder, name + "_thread")(*args, out_size),
           getattr(cuda_coder, name)(*args, out_size)]
    torch.cuda.synchronize()
    warp = int(streams <= cuda_coder.WARP_ENCODE_MAX_STREAMS)
    assert (cuda_coder.LAUNCHES[name], cuda_coder.LAUNCHES_WARP[name]) == (
        before[0] + 3, before[1] + 1 + warp)
    ref = (torch.empty_like(got[0][0]), torch.empty_like(got[0][1]))
    getattr(cuda_coder, name + "_plain")(*args, *ref)
    for out, lens in got:
        assert torch.equal(out, ref[0]) and torch.equal(lens, ref[1])
    return ref


def _scan_both_match_plain(ops, out_size, device):
    ops = as_tensors(ops, device)
    return _both_kernels_match_plain("encode_scan", ops, out_size,
                                     ops[0].shape[1])


# (steps, streams, share of coded steps, extra bytes a row: odd widths put
# most rows at odd addresses)
SCAN_CASES = {"dense": (700, 3, 1.0, 0), "holes_odd_rows": (700, 5, 0.6, 1),
              "sparse": (300, 4, 0.05, 3), "windows": (97, 33, 0.5, 0),
              "empty": (0, 2, 1.0, 1)}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_variants_match_plain(device, name):
    """Both kernels of the micro-op mode on random valid micro-ops with
    masked steps anywhere, in rows of even and odd width."""
    steps, streams, share, pad = SCAN_CASES[name]
    rng = np.random.RandomState(sorted(SCAN_CASES).index(name))
    _scan_both_match_plain(valid_micro_ops(rng, steps, streams, share),
                           2 * steps + 2 + pad, device)


def test_scan_variants_at_the_interval_limits(device):
    """Both kernels where encode_scan's contract ends: every coded step at
    a limit of the valid range (the whole range, its first or its last
    entry, at precision 1, 2, 15 and 16) writes encode_scan_plain's
    bytes."""
    rng = np.random.RandomState(15)
    _scan_both_match_plain(limit_micro_ops(rng, 600, 3), 1202, device)


@pytest.mark.parametrize("direction", ["up", "down"])
def test_scan_variants_long_delayed_carry(device, direction):
    """A delayed-carry group whose fill run (70 chunks) outlasts the warp
    kernel's window of 32, flushed up (0x00) and down (0xFF)."""
    ops, run = long_carry_ops(direction, 70, 5)
    out, lens = _scan_both_match_plain(ops, 2 * ops[0].shape[0] + 3, device)
    fill = b"\x00\x00" if direction == "up" else b"\xff\xff"
    assert fill * run in out[0, : int(lens[0])].cpu().numpy().tobytes()


def test_scan_golden_carry_case(device):
    """golden.npz's carry_p16 as micro-ops: both kernels write the
    reference coder's bytes."""
    gold = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "golden.npz"))
    cdf = gold["carry_p16__cdf"].astype(np.int64)
    data = gold["carry_p16__data"].astype(np.int64)
    ops = (cdf[data][:, None], cdf[data + 1][:, None],
           np.full((len(data), 1), 16), np.ones((len(data), 1), bool))
    out, lens = _scan_both_match_plain(ops, 2 * len(data) + 2, device)
    ref = gold["carry_p16__bytes"].tobytes()
    assert out[0, : int(lens[0])].cpu().numpy().tobytes() == ref


def test_scan_variant_follows_the_stream_count(device):
    """encode_scan takes the warp kernel up to WARP_ENCODE_MAX_STREAMS
    streams and the thread kernel above."""
    edge = cuda_coder.WARP_ENCODE_MAX_STREAMS
    rng = np.random.RandomState(14)
    ops = as_tensors(valid_micro_ops(rng, 40, edge + 1, 0.9), device)
    for streams, warp in ((edge, 1), (edge + 1, 0), (1, 1)):
        part = tuple(t[:, :streams].contiguous() for t in ops)
        before = (cuda_coder.LAUNCHES["encode_scan"],
                  cuda_coder.LAUNCHES_WARP["encode_scan"])
        out, lens = cuda_coder.encode_scan(*part, 82)
        assert (cuda_coder.LAUNCHES["encode_scan"],
                cuda_coder.LAUNCHES_WARP["encode_scan"]) == (
                    before[0] + 1, before[1] + warp)
        ref = (torch.empty_like(out), torch.empty_like(lens))
        cuda_coder.encode_scan_plain(*part, *ref)
        assert torch.equal(out, ref[0]) and torch.equal(lens, ref[1])


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("name", sorted(SYMBOL_CASES))
def test_symbol_variants_match_plain(device, name, pad):
    """Both kernels of K6' and of K1 and their wrappers on tests/
    symbol_cases.py's inputs (escapes in lane 0 and 31, several in a
    window, in the last partial window, negative, g = 2^31; streams of 0 to
    400 symbols; bounded rows at precision 1 to 16), in rows of even and
    odd width; K6''s streams decode back to the symbols (clipped on
    bounded rows)."""
    ragged, sym, idx = symbol_case(name)
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                       device)
    cdf, meta = table.indexed_arrays()
    sym = torch.as_tensor(sym, device=device)
    idx = torch.as_tensor(idx, device=device)
    counts = cuda_coder.interval_counts(sym, idx, meta)[0]
    steps = int(counts.sum(1).max()) if sym.numel() else 0
    args = (sym, idx, cdf, meta)
    buf, lens = _both_kernels_match_plain(
        "encode_gamma", args, 2 * steps + 2 + pad, sym.shape[0])
    _both_kernels_match_plain("encode_indexed", args,
                              2 * sym.shape[1] + 2 + pad, sym.shape[0])
    out, ok = cuda_coder.decode_gamma(buf, lens, idx, cdf, meta)
    # Bounded rows decode their clipped values; INT32_MIN does not
    # round-trip in the reference format.
    rows = idx.long().clamp(0, cdf.shape[0] - 1)
    maxs, _, ovf = meta.long()[rows].unbind(-1)
    expect = torch.where(ovf != 0, sym.long(),
                         torch.minimum(sym.long().clamp(min=0), maxs))
    keep = (sym != -2 ** 31).all(1)
    assert torch.equal(out[keep].long(), expect[keep])
    assert bool(ok[keep].all())


@pytest.mark.parametrize("slack", [0, 41])
@pytest.mark.parametrize("name", ["placements", "all_escapes"])
def test_gamma_variants_cut_a_short_row(device, name, slack):
    """Rows of 2 N + 2 + ``slack`` bytes, too short for some streams'
    Elias-gamma steps, in one launch with escape-free streams beside each
    escaping one.  The warp kernel (also as the wrapper's choice) equals
    its mirror byte for byte: every stream that could pass its row (2 T + 2
    bytes) cut, length row + 1, every other one as encode_gamma_plain
    codes it in a row long enough.  The thread kernel codes every stream
    whole and writes no byte past its row: the plain lengths, the plain
    bytes up to the row's end."""
    ragged, sym, idx = short_row_case(name)
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                       device)
    cdf, meta = table.indexed_arrays()
    args = (torch.as_tensor(sym, device=device),
            torch.as_tensor(idx, device=device), cdf, meta)
    steps = cuda_coder.interval_counts(*args[:2], meta)[0].sum(1)
    out_size = 2 * sym.shape[1] + 2 + slack
    cut = 2 * steps + 2 > out_size
    assert bool(cut.any()) and not bool(cut.all())
    ref = (torch.empty((sym.shape[0], 2 * int(steps.max()) + 2),
                       dtype=torch.uint8, device=device),
           torch.empty((sym.shape[0],), dtype=torch.int32, device=device))
    cuda_coder.encode_gamma_plain(*args, *ref)
    mirror = (torch.empty((sym.shape[0], out_size), dtype=torch.uint8),
              torch.empty((sym.shape[0],), dtype=torch.int32))
    cuda_coder.encode_gamma_warp_plain(*args, *mirror)
    for run in (cuda_coder.encode_gamma_warp, cuda_coder.encode_gamma):
        out, lens = run(*args, out_size)
        assert torch.equal(out.cpu(), mirror[0])
        assert torch.equal(lens.cpu(), mirror[1])
        assert bool((lens[cut] == out_size + 1).all())
        assert torch.equal(lens[~cut], ref[1][~cut])
        assert torch.equal(out[~cut], ref[0][~cut, :out_size])
    out, lens = cuda_coder.encode_gamma_thread(*args, out_size)
    assert torch.equal(lens, ref[1])
    assert torch.equal(out, ref[0][:, :out_size])


def test_symbol_variant_follows_the_stream_count(device):
    """encode_gamma and encode_indexed take the warp kernel up to
    WARP_ENCODE_MAX_STREAMS streams and the thread kernel above."""
    table = _table(16, True, device)
    cdf, meta = table.indexed_arrays()
    edge = cuda_coder.WARP_ENCODE_MAX_STREAMS
    rng = np.random.RandomState(16)
    idx = torch.as_tensor(rng.randint(0, 8, (edge + 1, 40)),
                          dtype=torch.int32, device=device)
    sym = torch.as_tensor(
        np.round(rng.laplace(0, 30, (edge + 1, 40))).astype(np.int32),
        device=device)
    out_size = torch_coder.stream_out_size(int(cuda_coder.interval_counts(
        sym, idx, meta)[0].sum(1).max()))
    for streams, warp in ((edge, 1), (edge + 1, 0), (1, 1)):
        part = sym[:streams].contiguous(), idx[:streams].contiguous()
        for name in ("encode_gamma", "encode_indexed"):
            before = (cuda_coder.LAUNCHES[name],
                      cuda_coder.LAUNCHES_WARP[name])
            out, lens = getattr(cuda_coder, name)(*part, cdf, meta,
                                                  out_size)
            assert (cuda_coder.LAUNCHES[name],
                    cuda_coder.LAUNCHES_WARP[name]) == (
                        before[0] + 1, before[1] + warp)
            ref = (torch.empty_like(out), torch.empty_like(lens))
            getattr(cuda_coder, name + "_plain")(*part, cdf, meta, *ref)
            assert torch.equal(out, ref[0]) and torch.equal(lens, ref[1])


# -- K2's two kernels ---------------------------------------------------------
def _indexed_streams(table, device, streams, n, seed, scale):
    """Sidecar streams (K1) of Laplace symbols, escapes on the overflow
    rows coded as the marker; returns (symbols as K2 gives them back,
    indexes, bytes, lengths)."""
    cdf, meta = table.indexed_arrays()
    rng = np.random.RandomState(seed)
    idx = torch.as_tensor(rng.randint(0, table.num_rows, (streams, n)),
                          dtype=torch.int32, device=device)
    sym = torch.as_tensor(
        np.round(rng.laplace(0, scale, (streams, n))).astype(np.int32),
        device=device)
    buf, lens = cuda_coder.encode_indexed(sym, idx, cdf, meta,
                                          torch_coder.stream_out_size(n))
    marker, _, ovf = meta.long()[idx.long()].unbind(-1)
    escape = (ovf != 0) & ((sym < 0) | (sym >= marker))
    back = torch.where(escape, marker,
                       torch.minimum(sym.long().clamp(min=0), marker))
    return back.to(torch.int32), idx, buf, lens


def _indexed_variants_match_plain(buf, lens, idx, table):
    """The wrapper and both kernels of K2 against decode_indexed_plain,
    run once; returns the plain result."""
    cdf, meta = table.indexed_arrays()
    before = (cuda_coder.LAUNCHES["decode_indexed"],
              cuda_coder.LAUNCHES_WARP["decode_indexed"])
    layout = table.warp_arrays()
    got = [cuda_coder.decode_indexed_warp(buf, lens, idx, cdf, meta, layout),
           cuda_coder.decode_indexed_thread(buf, lens, idx, cdf, meta),
           cuda_coder.decode_indexed(buf, lens, idx, cdf, meta, layout)]
    torch.cuda.synchronize()
    warp = int(buf.shape[0] <= cuda_coder.WARP_DECODE_MAX_STREAMS)
    assert (cuda_coder.LAUNCHES["decode_indexed"],
            cuda_coder.LAUNCHES_WARP["decode_indexed"]) == (
                before[0] + 3, before[1] + 1 + warp)
    ref = (torch.empty_like(got[0][0]), torch.empty_like(got[0][1]))
    cuda_coder.decode_indexed_plain(buf, lens, idx, cdf, meta, *ref)
    for out, ok in got:
        assert torch.equal(out, ref[0]) and torch.equal(ok, ref[1])
    return ref


@pytest.mark.parametrize("name", sorted(WARP_TABLES))
def test_indexed_decode_variants_match_plain(device, name):
    """The wrapper and both kernels of K2 on intact streams with escapes
    (round trip to the marker included), truncated, bit-flipped, random
    and empty ones, on tables that take each path of the warp kernel's
    search."""
    table = _table(17, True, device) if WARP_TABLES[name] is None else \
        _long_row_table(device, *WARP_TABLES[name], seed=18)
    sym, idx, buf, lens = _indexed_streams(table, device, 70, 150, 19, 60.0)
    out, ok = _indexed_variants_match_plain(buf, lens, idx, table)
    assert torch.equal(out, sym) and bool(ok.all())
    gen = torch.Generator(device=device).manual_seed(20)
    cols = torch.arange(buf.shape[1], device=device)
    flipped = buf ^ ((torch.rand(buf.shape, generator=gen, device=device)
                      < 0.01).to(torch.uint8) * 4)
    noise = torch.randint(0, 256, buf.shape, generator=gen, device=device,
                          dtype=torch.uint8)
    for b, ln in ((buf, lens // 2), (flipped, lens), (noise, lens),
                  (buf, torch.zeros_like(lens))):
        b = torch.where(cols[None, :] < ln[:, None], b, 0).to(torch.uint8)
        _indexed_variants_match_plain(b.contiguous(), ln.contiguous(), idx,
                                      table)


@pytest.mark.parametrize("width", [41, 64, 1031])
def test_indexed_decode_variants_short_streams_and_odd_widths(device, width):
    """Streams of 0, 1, 2, 3 and ``width`` bytes in a buffer full of noise,
    also from a view one byte into its storage (most rows start
    unaligned)."""
    table = _table(21, True, device)
    gen = torch.Generator(device=device).manual_seed(width + 1)
    buf = torch.randint(0, 256, (40, width), generator=gen, device=device,
                        dtype=torch.uint8)
    lens = torch.tensor([0, 1, 2, 3, width] * 8, dtype=torch.int32,
                        device=device)
    idx = torch.randint(0, 8, (40, 600), generator=gen, device=device,
                        dtype=torch.int32)
    _indexed_variants_match_plain(buf, lens, idx, table)
    flat = torch.randint(0, 256, (40 * width + 1,), generator=gen,
                         device=device, dtype=torch.uint8)
    _indexed_variants_match_plain(flat[1:].view(40, width), lens, idx, table)


# The native main paths' K2 launches: bls2017's 512x512 and 768x512 image,
# bmshj2018's y and z (streams, symbols, table).
NATIVE_SHAPES = {"bls2017_512": (256, 512, "short"),
                 "bls2017_768": (512, 384, "short"),
                 "bmshj2018_y": (512, 384, "two_level"),
                 "bmshj2018_z": (32, 384, "short")}


@pytest.mark.parametrize("name", sorted(NATIVE_SHAPES))
def test_indexed_decode_variants_at_native_shapes(device, name):
    streams, n, kind = NATIVE_SHAPES[name]
    table = _table(22, True, device) if kind == "short" else \
        _long_row_table(device, 64, 1481, seed=23)
    sym, idx, buf, lens = _indexed_streams(table, device, streams, n, 24,
                                           20.0)
    out, ok = _indexed_variants_match_plain(buf, lens, idx, table)
    assert torch.equal(out, sym) and bool(ok.all())


def test_indexed_decode_partial_last_block(device):
    """K2's warp kernel with a stream count that fills no last block, the
    table in shared memory and in global memory."""
    for table in (_long_row_table(device, 6, 1481, seed=25),
                  _long_row_table(device, 120, 1100, seed=26)):
        sym, idx, buf, lens = _indexed_streams(table, device, 37, 90, 27,
                                               40.0)
        out, ok = _indexed_variants_match_plain(buf, lens, idx, table)
        assert torch.equal(out, sym) and bool(ok.all())


def test_indexed_decode_variant_follows_the_stream_count(device):
    """decode_indexed takes the warp kernel up to WARP_DECODE_MAX_STREAMS
    streams and the thread kernel above, through the front end's sidecar
    decode."""
    table = _table(28, True, device)
    edge = cuda_coder.WARP_DECODE_MAX_STREAMS
    sym, idx, buf, lens = _indexed_streams(table, device, edge + 1, 40, 29,
                                           30.0)
    for streams, warp in ((edge, 1), (edge + 1, 0), (1, 1)):
        before = (cuda_coder.LAUNCHES["decode_indexed"],
                  cuda_coder.LAUNCHES_WARP["decode_indexed"])
        out, ok = torch_coder.decode_dispatch(
            buf[:streams].contiguous(), lens[:streams].contiguous(), 40,
            table, idx[:streams].contiguous())
        assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "cuda-indexed"
        assert (cuda_coder.LAUNCHES["decode_indexed"],
                cuda_coder.LAUNCHES_WARP["decode_indexed"]) == (
                    before[0] + 1, before[1] + warp)
        assert torch.equal(out, sym[:streams]) and bool(ok.all())


# -- the host C coder against the reference-format kernels -------------------
@pytest.mark.parametrize("mode", ["indexed", "single_row"])
def test_host_coder_bytes_equal_kernels(device, mode):
    """codec.host's bytes equal torch_coder.encode_streams' on the card
    (K6' / K1 in indexed mode with escapes, K4' on one row), and its decode
    gives the card's symbols and sanity flags."""
    from compression_tpu_torch.codec import host
    gen = torch.Generator(device=device).manual_seed(5)
    if mode == "indexed":
        table = _table(1, True, device)
        idx = torch.randint(0, 8, (300, 77), generator=gen, device=device,
                            dtype=torch.int32)
        sym = torch.randint(-3, 45, (300, 77), generator=gen, device=device,
                            dtype=torch.int32)
    else:
        table = _table(2, False, device)
        table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
            tables.build_ragged_cdf([table.host.cdf[0][:table.host.length[0]]],
                                    [int(table.host.precision[0])], [False])),
            device)
        idx = None
        sym = torch.randint(0, int(table.host.length[0]) - 1, (300, 77),
                            generator=gen, device=device, dtype=torch.int32)
    buf, lens = torch_coder.encode_streams(sym, table, idx)
    idx_np = None if idx is None else idx.cpu().numpy()
    strings = host.encode_streams(sym.cpu().numpy(), table.host, idx_np)
    assert strings == torch_coder.to_bytes_list(buf.cpu().numpy(),
                                                lens.cpu().numpy())
    dec, ok = torch_coder.decode_streams(buf, lens, 77, table, idx)
    h_dec, h_ok = host.decode_streams(strings, 77, table.host, idx_np)
    np.testing.assert_array_equal(h_dec, dec.cpu().numpy())
    np.testing.assert_array_equal(h_ok, ok.cpu().numpy())


# -- a train step on the card against the CPU --------------------------------
@pytest.fixture()
def no_tf32():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.parametrize("name", ["bls2017", "bmshj2018", "ms2020"])
def test_train_step_card_matches_cpu(device, no_tf32, name):
    """One step of each model at 16 filters (ms2020 at the compact widths
    of tests/test_torch_ms2020.py), batch 2 of 64x64, on the card and on
    the CPU from the same parameters, batch and noise, TF32 off: metrics
    within rtol 1e-4, every gradient within 1e-3 of its largest
    magnitude.  A generator on the card draws there; one on the CPU
    raises."""
    from compression_tpu_torch.models import bls2017, bmshj2018, ms2020
    if name == "bls2017":
        models = [bls2017.BLS2017Model(num_filters=16, seed=3)
                  for _ in range(2)]
    elif name == "bmshj2018":
        models = [bmshj2018.BMSHJ2018Model(num_filters=16, num_scales=16,
                                           seed=3) for _ in range(2)]
    else:
        models = [ms2020.MS2020Model(**MS2020_COMPACT, seed=3)
                  for _ in range(2)]
    card = models[1].to(device)
    cpu = models[0]
    x = torch.as_tensor(np.random.RandomState(1).randint(
        0, 256, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        if name == "bls2017":
            shapes = [tuple(cpu.analysis(x).shape)]
        else:
            y, z = cpu.encode(x)
            shapes = [tuple(z.shape)]
            if name == "bmshj2018":
                shapes.append(tuple(y.shape))
            else:
                shapes += [y.shape[:-1] + (cpu.slice_depth,)
                           ] * cpu.num_slices
    rng = np.random.RandomState(2)
    u = [torch.as_tensor(rng.uniform(-.5, .5, s).astype(np.float32))
         for s in shapes]
    u_cpu = u[0] if name == "bls2017" else tuple(u)
    u_card = u[0].to(device) if name == "bls2017" else tuple(
        t.to(device) for t in u)
    results = []
    for model, batch, noise in ((cpu, x, u_cpu), (card, x.to(device),
                                                  u_card)):
        model.zero_grad()
        loss, bpp, mse = model(batch, training=True, u=noise)
        loss.backward()
        results.append(([t.item() for t in (loss, bpp, mse)],
                        {k: p.grad.cpu() for k, p in
                         model.named_parameters()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-4)
    for k, want in results[0][1].items():
        # The error itself where the gradient is all zero (ms2020's hyper
        # synthesis when z rounds to zero).
        scale = float(want.abs().max())
        err = float((results[1][1][k] - want).abs().max()) / (
            scale if scale > 0 else 1.0)
        assert err <= 1e-3, (k, err)
    step = bls2017.make_train_step(
        card, torch.optim.Adam(card.parameters(), lr=1e-3))
    metrics = step(x, generator=torch.Generator(device=device).manual_seed(0))
    assert all(v.device.type == "cuda" and v.shape == ()
               for v in metrics.values())
    with pytest.raises(ValueError):
        step(x, generator=torch.Generator().manual_seed(0))


# -- the classic containers on the kernels, ms2020 and HiFiC ---------------
MS2020_COMPACT = dict(num_filters=16, latent_depth=20, hyperprior_depth=8,
                      num_slices=5, max_support_slices=3, num_scales=16,
                      ha_widths=(24, 16), hs_widths=(12, 16, 20),
                      slice_widths=(16, 12))
# tests/test_torch_hific.py's compact configuration (four downsamplings).
HIFIC_COMPACT = dict(num_down=4, num_filters_base=4,
                     num_filters_bottleneck=12, num_residual_blocks=2,
                     hyper_filters=8)


def _small_codecs(device):
    from compression_tpu_torch.models import bls2017, bmshj2018, hific
    from compression_tpu_torch.models import ms2020
    return {
        "bls2017": bls2017.BLS2017Codec(
            bls2017.BLS2017Model(num_filters=16, seed=2), device=device),
        "bmshj2018": bmshj2018.BMSHJ2018Codec(
            bmshj2018.BMSHJ2018Model(num_filters=16, seed=2),
            device=device),
        "ms2020": ms2020.MS2020Codec(ms2020.MS2020Model(
            **MS2020_COMPACT, seed=2), device=device),
        "hific": hific.HiFiCCodec(hific.HiFiCModel(
            hific.HiFiCConfig(**HIFIC_COMPACT), seed=2), device=device),
    }


@pytest.mark.parametrize("name", ["bls2017", "bmshj2018", "ms2020", "hific"])
def test_classic_container_launches_the_kernels(device, monkeypatch, name):
    """On the card a classic container's one-stream calls launch the
    kernels (no host route, whatever the JAX package's
    CTPU_HOST_ROUTE_MAX_STREAMS says), and the container decodes to
    reconstruct(x)."""
    codec = _small_codecs(device)[name]
    x = np.random.RandomState(4).randint(0, 256, (80, 72, 3)).astype(
        np.uint8)
    expect = codec.reconstruct(x)
    container = codec.compress(x)
    for limit in ("256", "100000"):
        monkeypatch.setenv("CTPU_HOST_ROUTE_MAX_STREAMS", limit)
        assert codec.compress(x) == container
        assert torch_coder.DISPATCH_LOG["encode"] in ("cuda-gamma",
                                                      "cuda-indexed")
        np.testing.assert_array_equal(codec.decompress(container), expect)
        assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"


@pytest.mark.parametrize("batch", [1, 4])
def test_entropy_model_calls_launch_the_kernels(device, batch):
    """The entropy models' compress / compress_to_strings / decompress
    give one stream per batch element and launch the kernels at one
    stream and at a few; each element's stream equals its own call's."""
    codec = _small_codecs(device)["bmshj2018"]
    rng = np.random.RandomState(7)
    xs = [rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
          for _ in range(batch)]
    with torch.no_grad():
        parts = [codec._encode(codec._upload(x)) for x in xs]
        y = torch.cat([p[0] for p in parts])
        z = torch.cat([p[1] for p in parts])
        indexes = torch.cat([p[2] for p in parts])
        for em, latent, args, shape_arg in (
                (codec.em, y, (indexes,), indexes),
                (codec.side_em, z, (), tuple(z.shape[1:3]))):
            strings = em.compress_to_strings(latent, *args)
            assert torch_coder.DISPATCH_LOG["encode"] in ("cuda-gamma",
                                                          "cuda-indexed")
            assert len(strings) == batch
            assert strings == sum((em.compress_to_strings(
                latent[i:i + 1], *(a[i:i + 1] for a in args))
                for i in range(batch)), [])
            buf, lens = em.compress(latent, *args)
            assert torch_coder.DISPATCH_LOG["encode"] in ("cuda-gamma",
                                                          "cuda-indexed")
            out = em.decompress(strings, shape_arg)
            assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"
            assert torch.equal(out, em.quantize(latent))
            out = em.decompress(buf, shape_arg, lengths=lens)
            assert torch.equal(out, em.quantize(latent))


def test_device_only_pair_launches_on_one_stream(device):
    """compress_device / decompress_device launch their kernels on one
    stream."""
    codec = _small_codecs(device)["bmshj2018"]
    x = np.random.RandomState(5).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    with torch.no_grad():
        y, _, indexes, _ = codec._encode(codec._upload(x))
        buf, lens, ok = codec.em.compress_device(y, indexes)
        assert torch_coder.DISPATCH_LOG["encode"].startswith("cuda-")
        back, sane = codec.em.decompress_device(buf.reshape(1, -1),
                                                lens.reshape(1), indexes)
    assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"
    assert bool(ok) and bool(sane.all())
    assert torch.equal(back, codec.em.quantize(y))


def test_ms2020_native_path_on_the_card(device):
    """ms2020's native container runs K1 (one launch for z, one for the
    stacked slices) and K2 (z, then one launch a slice), and both
    containers decode to reconstruct(x)."""
    codec = _small_codecs(device)["ms2020"]
    x = np.random.RandomState(6).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    expect = codec.reconstruct(x)
    before = (cuda_coder.LAUNCHES["encode_indexed"],
              cuda_coder.LAUNCHES["decode_indexed"])
    native = codec.compress_native(x)
    assert torch_coder.DISPATCH_LOG["encode"] == "cuda-indexed"
    np.testing.assert_array_equal(codec.decompress(native), expect)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "cuda-indexed"
    assert (cuda_coder.LAUNCHES["encode_indexed"],
            cuda_coder.LAUNCHES["decode_indexed"]) == (
                before[0] + 2, before[1] + 1 + codec.model.num_slices)
    np.testing.assert_array_equal(codec.decompress(codec.compress(x)),
                                  expect)
    assert codec.compress_native_many([x, x[:48]]) == [
        native, codec.compress_native(x[:48])]


@pytest.mark.parametrize("fixture", ["golden_ms2020.npz",
                                     "golden_ms2020_full.npz"])
def test_ms2020_goldens_on_the_card(device, fixture):
    """Both ms2020 goldens on the card: the tables, the reference's z and
    slice strings from compress, its container decoding to its image, and
    the native container decoding to it too."""
    import importlib.util
    import json
    from compression_tpu_torch.models import ms2020
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    gold_dir = os.path.join(os.path.dirname(__file__), "golden")
    gold = dict(np.load(os.path.join(gold_dir, fixture)))
    tf_vars = gold
    if "manifest" in gold:
        spec = importlib.util.spec_from_file_location(
            "synth_weights", os.path.join(gold_dir, "synth_weights.py"))
        synth = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(synth)
        manifest = json.loads(gold["manifest"].tobytes().decode())
        tf_vars = {k: synth.synth(k, s) for k, (s, _) in manifest.items()}
    model = ms2020.MS2020Model(
        num_filters=int(gold["num_filters"]),
        latent_depth=int(gold["latent_depth"]),
        hyperprior_depth=int(gold["hyperprior_depth"]),
        num_slices=int(gold["num_slices"]),
        max_support_slices=int(gold["max_support_slices"]),
        num_scales=int(gold["num_scales"]),
        ha_widths=tuple(int(w) for w in gold["ha_widths"]),
        hs_widths=tuple(int(w) for w in gold["hs_widths"]),
        slice_widths=tuple(int(w) for w in gold["slice_widths"]))
    model.load_state_dict(ms2020.params_from_tf(tf_vars))
    codec = ms2020.MS2020Codec(model, device=device)
    np.testing.assert_array_equal(codec.em_y.cdf, gold["cdf_y"])
    np.testing.assert_array_equal(codec.em_z.cdf, gold["cdf_z"])

    def strings(prefix):
        out, off, buf = [], 0, gold[f"{prefix}_bytes"].tobytes()
        for n in gold[f"{prefix}_nbytes"]:
            out.append(buf[off:off + int(n)])
            off += int(n)
        return out

    ns = int(gold["num_slices"])
    fields = PackedTensors(codec.compress(gold["x_test"])).unpack(
        [np.int32] * 3 + ["bytes"] * (1 + ns))
    assert fields[3] == strings("z")
    assert [f[0] for f in fields[4:]] == strings("y")
    np.testing.assert_array_equal(
        codec.decompress(gold["container"].tobytes()), gold["x_hat_uint8"])
    np.testing.assert_array_equal(
        codec.decompress(codec.compress_native(gold["x_test"])),
        gold["x_hat_uint8"])


def test_hific_native_path_on_the_card(device):
    """HiFiC's native container runs two K1 launches (y, z) and two K2
    launches (z, then y), both on their warp kernels, and both containers
    and the *_many calls decode to reconstruct(x); then K1 and K2 at the
    native launch of y, on the codec's own symbols and scale indexes
    about the means, against their plain versions."""
    from compression_tpu_torch.models import native_format
    codec = _small_codecs(device)["hific"]
    x = np.random.RandomState(8).randint(0, 256, (72, 88, 3)).astype(
        np.uint8)
    expect = codec.reconstruct(x)
    before = {k: (cuda_coder.LAUNCHES[k], cuda_coder.LAUNCHES_WARP[k])
              for k in ("encode_indexed", "decode_indexed")}
    native = codec.compress_native(x)
    assert torch_coder.DISPATCH_LOG["encode"] == "cuda-indexed"
    np.testing.assert_array_equal(codec.decompress(native), expect)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "cuda-indexed"
    for k, (count, warp) in before.items():
        assert (cuda_coder.LAUNCHES[k], cuda_coder.LAUNCHES_WARP[k]) == (
            count + 2, warp + 2), k
    np.testing.assert_array_equal(codec.decompress(codec.compress(x)),
                                  expect)
    assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"
    images = [x, x[:48]]
    many = codec.compress_native_many(images)
    assert many == [native, codec.compress_native(x[:48])]
    for out, c in zip(codec.decompress_native_many(many), many):
        np.testing.assert_array_equal(out, codec.decompress(c))
    with torch.no_grad():
        y, _, indexes, means = codec._encode(codec._upload(x))
        sym, idx, _ = codec.em._symbols(
            native_format.to_streams(y - means),
            native_format.to_streams(indexes))
    table = codec.em.device_table
    cdf, meta = table.indexed_arrays()
    out_size = torch_coder.stream_out_size(sym.shape[1])
    buf, lens = cuda_coder.encode_indexed(sym, idx, cdf, meta, out_size)
    out_p, len_p = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_indexed_plain(sym, idx, cdf, meta, out_p, len_p)
    assert torch.equal(buf, out_p) and torch.equal(lens, len_p)
    dec, san = cuda_coder.decode_indexed(buf, lens, idx, cdf, meta,
                                         table.warp_arrays())
    dec_p, san_p = torch.empty_like(dec), torch.empty_like(san)
    cuda_coder.decode_indexed_plain(buf, lens, idx, cdf, meta, dec_p, san_p)
    assert torch.equal(dec, dec_p) and torch.equal(san, san_p)
    assert bool(san.all())


def test_hific_gan_steps_card_match_cpu(device, no_tf32, tmp_path):
    """One g step and one d step of HiFiC's compact configuration (four
    downsamplings) with the tests' tiny discriminator and LPIPS on one npz
    of random weights, batch 2 of 64x64, on the card and on the CPU from
    the same parameters, batch and noise, TF32 off, the CPU taking the
    card's decisions at the kinks (util/kinks.SharedKinks over hific,
    lpips and round_st: a value within float error of a relu's, a max-pool's
    or a rounding's kink moves a small kernel's gradient by more than the
    arithmetic does) and the d step starting on both from the card's
    generator after its g step: metrics within rtol 1e-4, every gradient
    within 1e-3 of its largest magnitude, the discriminator's stored u and
    sigma within 1e-5; the steps' metrics stay on the card."""
    import copy

    from compression_tpu_torch.models import hific, lpips
    from compression_tpu_torch.ops import round_ops
    from compression_tpu_torch.util.kinks import SharedKinks
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **{k: v.numpy() for k, v in
                      lpips.random_lpips_weights(seed=1).items()})
    cfg = hific.HiFiCConfig(**HIFIC_COMPACT)
    template = hific.HiFiCModel(cfg, seed=4)
    disc_template = hific.Discriminator(template.latent_depth,
                                        num_filters_base=4, num_layers=2,
                                        num_down=4, seed=4)
    x = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        y, z = template.encode(torch.as_tensor(x))
    rng = np.random.RandomState(2)
    u = [tuple(torch.as_tensor(rng.uniform(-.5, .5, s).astype(np.float32))
               for s in (z.shape, y.shape)) for _ in range(2)]

    def run(dev, after_g=None):
        model = copy.deepcopy(template).to(dev)
        disc = copy.deepcopy(disc_template).to(dev)
        g_step, d_step = hific.make_train_steps(
            model, disc, torch.optim.Adam(model.parameters(), lr=1e-4),
            torch.optim.Adam(disc.parameters(), lr=1e-4),
            lpips_weights_path=path)
        noise = [tuple(t.to(dev) for t in n) for n in u]
        metrics = g_step(x, 0, u=noise[0])
        state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        if after_g is not None:
            model.load_state_dict(after_g)
        metrics.update(d_step(x, u=noise[1]))
        assert all(v.device.type == torch.device(dev).type and v.shape == ()
                   for v in metrics.values())
        grads = {**{k: p.grad.cpu() for k, p in model.named_parameters()},
                 **{f"disc.{k}": p.grad.cpu()
                    for k, p in disc.named_parameters()}}
        return ({k: float(v) for k, v in metrics.items()}, grads,
                {k: b.cpu() for k, b in disc.named_buffers()}, state)

    kinks = SharedKinks()
    with kinks.sharing(hific, lpips, round_ops=round_ops):
        m_card, g_card, s_card, after_g = run(device)
        kinks.replay = list(kinks.masks)
        m_cpu, g_cpu, s_cpu, _ = run("cpu", after_g)
        assert not kinks.replay
    for k, v in m_cpu.items():
        np.testing.assert_allclose(m_card[k], v, rtol=1e-4, err_msg=k)
    for k, want in g_cpu.items():
        scale = float(want.abs().max())
        err = float((g_card[k] - want).abs().max()) / (
            scale if scale > 0 else 1.0)
        assert err <= 1e-3, (k, err)
    for k, want in s_cpu.items():
        assert float((s_card[k] - want).abs().max()) <= 1e-5, k


@pytest.mark.parametrize("name", ["bls2017", "bmshj2018", "ms2020"])
def test_tfci_round_trip_on_the_card(device, tmp_path, name):
    """The command line on the card at tiny widths: ``<model>.main train``
    (2 steps), ``tfci compress`` / ``decompress``: the container equals
    the loaded codec's compress, the image its reconstruct, and the
    classic calls launch K1 or K6' and K3'."""
    from compression_tpu_torch.models import bls2017, bmshj2018, ms2020, tfci
    module = {"bls2017": bls2017, "bmshj2018": bmshj2018,
              "ms2020": ms2020}[name]
    flags = {"bls2017": ["--num_filters", "8"],
             "bmshj2018": ["--num_filters", "8"],
             "ms2020": ["--num_filters", "8", "--latent_depth", "8",
                        "--hyperprior_depth", "4", "--num_slices", "4",
                        "--max_support_slices", "2"]}[name]
    root = str(tmp_path)
    module.main(["train", "--model_path", os.path.join(root, name),
                 "--steps", "2", "--batchsize", "2", "--patchsize", "64",
                 *flags])
    x = np.random.RandomState(5).randint(0, 256, (64, 80, 3)).astype(
        np.uint8)
    src = os.path.join(root, "img.npy")
    np.save(src, x)
    tfci.main(["--model_path", root, "compress", name, src])
    assert torch_coder.DISPATCH_LOG["encode"] in ("cuda-gamma",
                                                  "cuda-indexed")
    tfci.main(["--model_path", root, "decompress", src + ".tfci",
               os.path.join(root, "out.npy")])
    assert torch_coder.DISPATCH_LOG["decode"] == "cuda-gamma"
    codec = tfci._load_codec(root, name, device)
    assert open(src + ".tfci", "rb").read() == codec.compress(x)
    np.testing.assert_array_equal(np.load(os.path.join(root, "out.npy")),
                                  codec.reconstruct(x))


@pytest.mark.parametrize("escapes", [False, True])
@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_universal_models_on_the_card(device, kind, escapes):
    """tests/universal_cases.py's models (2880 and 960 table rows, both
    read from global memory) on CUDA tensors at 2 streams of 4 x 8 x 192:
    the bytes of the CPU's plain path and of the host C coder, one K1 (no
    escape) or K6' (escapes) and one K3', the round trip equal to the
    dithered quantization."""
    import universal_cases as cases
    from compression_tpu_torch.codec import host
    make = {"batched": cases.batched_model, "indexed": cases.indexed_model}
    card, cpu = make[kind](device), make[kind]("cpu")
    y_b, y_i, idx = cases.latents((2, 4, 8, cases.CHANNELS), escapes)
    x = y_b if kind == "batched" else y_i
    args = () if kind == "batched" else (torch.tensor(idx),)
    before = dict(cuda_coder.LAUNCHES)
    strings = card.compress_to_strings(torch.tensor(x, device=device),
                                       *[a.to(device) for a in args])
    took = "encode_gamma" if escapes else "encode_indexed"
    assert _launched(took, before)
    assert strings == cpu.compress_to_strings(torch.tensor(x), *args)
    symbols, rows, _ = cpu._symbols(torch.tensor(x), *args)
    assert strings == host.encode_streams(
        symbols.numpy(), cpu.device_table.host, rows.numpy())
    shape = (4, 8) if kind == "batched" else args[0].to(device)
    before = dict(cuda_coder.LAUNCHES)
    out = card.decompress(strings, shape)
    assert _launched("decode_gamma", before)
    # The dithered quantization, by the eval-mode call on the CPU (the
    # batched model's prior lives there, with its tables).
    assert torch.equal(out.cpu(), cpu(torch.tensor(x), *args,
                                      training=False)[0])


CODER_KERNEL = re.compile(r"(encode|decode)\w*_kernel|pair_lookup_kernel")


@pytest.mark.parametrize("entry", ["compress", "compress_native"])
def test_spans_share_the_device_trace_clock(device, entry):
    """bmshj2018 at 16 filters on a 64x64 image under torch.profiler: every
    coder kernel starts after the start of the ``coder.launch.*`` span that
    enqueued it, and within its request's entry span; the program's spans
    enclose the profiler's events of their names; the GPU-side copies of
    the spans are user annotations, not kernels."""
    from torch.profiler import ProfilerActivity, profile

    from compression_tpu_torch.models import bmshj2018
    from compression_tpu_torch.util import profiling

    codec = bmshj2018.BMSHJ2018Codec(
        bmshj2018.BMSHJ2018Model(num_filters=16), device=device)
    x = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    run = lambda: codec.decompress(getattr(codec, entry)(x))  # noqa: E731
    run()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    records = profiling.spans()
    host, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        span = (start, start + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name().startswith("ctpu."):
                assert e.is_user_annotation(), e.name()
            elif CODER_KERNEL.search(e.name()):
                kernels.append(span)
        elif e.name().startswith("ctpu."):
            host.setdefault(e.name(), []).append(span)
    for label, events in host.items():
        mine = sorted((r.start_ns, r.end_ns) for r in records
                      if r.label == label)
        assert len(mine) == len(events), label
        for (s0, s1), (e0, e1) in zip(mine, sorted(events)):
            assert s0 <= e0 and e1 <= s1, label
    launches = [r for r in records if r.layer == "coder"]
    assert launches and len(launches) == len(kernels)
    assert {r.kind for r in launches} == {"dispatch"}
    by_id = {r.id: r for r in records}
    for span, (k0, k1) in zip(launches, sorted(kernels)):
        entry_span = span
        while entry_span.parent is not None:
            entry_span = by_id[entry_span.parent]
        assert span.start_ns <= k0, span
        assert entry_span.start_ns <= k0 and k1 <= entry_span.end_ns, span
