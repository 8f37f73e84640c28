"""The port's micro-op encode route and its two last kernels against the JAX
package: ``micro_ops_from_symbols`` / ``encode_core`` /
``encode_streams_budgeted`` of compression_tpu_torch.codec.torch_coder, the
plain version of the pair lookup (K7') and the plain version of the bucketed
single-row decode (K8'), with the plain mirror of K8''s kernel (K5''s
threshold, 32-bit counts over the buckets and the window, the interval read
at the window's count) against the exact products.

Every comparison is exact (micro-op arrays, bytes, lengths, symbols, sanity
flags): the coder has no tolerance.  The JAX package's Pallas kernels run in
interpret mode, as its own tests run them on the CPU.
"""

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from compression_tpu.codec import jax_coder, pallas_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder

torch.set_num_threads(1)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_coder.pl, "pallas_call", patched)


def _ragged(rng, overflows, prec_range=(8, 17), max_alphabet=30):
    cdfs, precs = [], []
    for _ in overflows:
        prec = int(rng.randint(*prec_range))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, max_alphabet))))
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    return jax_tables.build_ragged_cdf(cdfs, precs, list(overflows))


def _tables(ragged):
    return (jax_coder.DeviceCdfTable(jax_tables.parse_ragged_cdf(ragged)),
            torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu"))


def _data(rng, num_rows, s, n, scale):
    idx = rng.randint(0, num_rows, (s, n)).astype(np.int32)
    sym = np.round(rng.laplace(0, scale, (s, n))).astype(np.int32)
    return sym, idx


def _assert_ops_equal(mine, ref):
    for name, a, b in zip(("lower", "upper", "prec", "mask"), mine, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_array_equal(
            a.numpy().astype(np.int64), np.asarray(b).astype(np.int64),
            err_msg=name)


# (overflow flag per row, slots K (None: what the data needs), extra steps)
MICRO_CASES = {
    # Branch 1 of micro_ops_from_symbols: no overflow row, K = 1.
    "bounded_rows": ([False] * 5, 1, 0),
    "bounded_single_row_padded": ([False], 1, 64),
    # Branch 2: overflow rows but K = 1 (escapes become the bare marker).
    "overflow_rows_k1": ([True, False, True], 1, 27),
    # Branch 3: the compacting scatter.
    "escapes_exact_budget": ([True, False, True, True], None, 0),
    "escapes_padded_steps": ([True, True], None, 100),
    "escapes_wide_slots": ([True, False], 35, 40),
    "escapes_slots_cut": ([True, True, False], 5, 10),
    "escapes_steps_cut": ([True, True], None, -30),
}


@pytest.mark.parametrize("name", sorted(MICRO_CASES))
def test_micro_ops_match_jax(name):
    """micro_ops_from_symbols == jax_coder.micro_ops_from_symbols: all
    three branches, mixed precisions, escapes of both signs and the INT32
    extremes, padded steps, and budgets (slots or steps) that cut."""
    overflows, slots, extra = MICRO_CASES[name]
    rng = np.random.RandomState(sorted(MICRO_CASES).index(name))
    ragged = _ragged(rng, overflows)
    sym, idx = _data(rng, len(overflows), 9, 41, 20.0)
    sym[:6, 3] = [INT32_MIN, INT32_MAX, -(2 ** 20), 2 ** 16 + 3, -1, -70000]
    idx[:6, 3] = 0
    jt, pt = _tables(ragged)
    counts = cuda_coder.interval_counts(
        torch.as_tensor(sym), torch.as_tensor(idx), pt.indexed_arrays()[1])[0]
    if slots is None:
        slots = int(counts.max())
    total = 41 if slots == 1 else int(counts.sum(1).max())
    num_steps = total + extra
    ref = jax_coder.micro_ops_from_symbols(
        jnp.asarray(sym), jnp.asarray(idx), jt, slots, num_steps)
    mine = torch_coder.micro_ops_from_symbols(
        torch.as_tensor(sym), torch.as_tensor(idx), pt, slots, num_steps)
    assert all(t.dtype == torch.int32 for t in mine[:3])
    assert mine[3].dtype == torch.bool
    _assert_ops_equal(mine, ref)


@pytest.mark.parametrize("num_rows,max_alphabet", [(1, 300), (7, 30),
                                                   (300, 260)])
def test_pair_lookup_plain_matches_jax(num_rows, max_alphabet):
    """K7' plain == jax_coder._cdf_pair_lookup (the one-hot formulation
    below 65536 table entries, the gather above)."""
    rng = np.random.RandomState(num_rows)
    ragged = _ragged(rng, [False] * num_rows, prec_range=(12, 17),
                     max_alphabet=max_alphabet)
    jt, pt = _tables(ragged)
    rows = rng.randint(0, num_rows, (13, 50)).astype(np.int32)
    vq = (rng.randint(0, 1 << 20, rows.shape) % (
        np.asarray(pt.host.length)[rows] - 1)).astype(np.int32)
    ref_lo, ref_hi = jax_coder._cdf_pair_lookup(
        jt, jnp.asarray(rows), jnp.asarray(vq))
    cdf, _ = pt.indexed_arrays()
    flat = cdf.reshape(-1)
    idx = torch.as_tensor(rows * pt.max_len + vq)
    for fn in (cuda_coder.pair_lookup, cuda_coder.pair_lookup_plain):
        lo, hi = fn(flat, idx)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))


def test_pair_lookup_plain_matches_pallas_kernel(interpret_pallas):
    """K7' plain == pallas_coder.pair_lookup_pallas (interpret mode) on
    the 17-wide windows of the same flat table."""
    rng = np.random.RandomState(3)
    k = 257
    flat = np.sort(rng.randint(0, 2 ** 16, k)).astype(np.int32)
    nb = -(-k // 16)
    padded = np.concatenate(
        [flat, np.full(16 * nb + 1 - k, flat[-1], np.int32)])
    win17 = np.concatenate(
        [padded[: 16 * nb].reshape(nb, 16), padded[16::16][:, None]], axis=1)
    idx = rng.randint(0, k - 1, (128, 256)).astype(np.int32)
    ref_lo, ref_hi = pallas_coder.pair_lookup_pallas(
        jnp.asarray(win17), jnp.asarray(idx))
    lo, hi = cuda_coder.pair_lookup(torch.as_tensor(flat),
                                    torch.as_tensor(idx))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))


def test_pair_lookup_checks_arguments():
    flat = torch.arange(10, dtype=torch.int32)
    good = torch.zeros((2, 3), dtype=torch.int32)
    for bad in (9, -1):
        with pytest.raises(ValueError):
            cuda_coder.pair_lookup(flat, torch.full_like(good, bad))
    with pytest.raises(ValueError):
        cuda_coder.pair_lookup(flat, good.long())
    with pytest.raises(ValueError):
        cuda_coder.pair_lookup(flat[:1], good)
    lo, hi = cuda_coder.pair_lookup(flat, torch.full_like(good, 8))
    assert int(lo[0, 0]) == 8 and int(hi[0, 0]) == 9
    # The plain version clamps as the kernel does.
    lo, hi = cuda_coder.pair_lookup_plain(flat, torch.full_like(good, 99))
    assert int(lo[0, 0]) == 8 and int(hi[0, 0]) == 9


ENCODE_CASES = {
    "escapes": ([True, False, True, True], None),
    "wide_slots": ([True, True], 35),
    "no_escapes_k1": ([True, False], 1),
    "bounded_k1": ([False, False, False], 1),
}


@pytest.mark.parametrize("name", sorted(ENCODE_CASES))
def test_encode_core_matches_jax(name):
    """encode_core over the port's micro-ops == jax_coder.encode_core over
    the JAX package's: padded bytes and lengths; with escapes also == the
    port's K6' plain (encode_gamma) and jax_coder.encode_streams."""
    overflows, slots = ENCODE_CASES[name]
    rng = np.random.RandomState(10 + sorted(ENCODE_CASES).index(name))
    ragged = _ragged(rng, overflows)
    scale = 2.0 if name == "no_escapes_k1" else 20.0
    sym, idx = _data(rng, len(overflows), 12, 37, scale)
    if name == "no_escapes_k1":
        sym = np.abs(sym) % 2  # inside every row's range
    jt, pt = _tables(ragged)
    cdf, meta = pt.indexed_arrays()
    counts = cuda_coder.interval_counts(
        torch.as_tensor(sym), torch.as_tensor(idx), meta)[0]
    if slots is None:
        slots = int(counts.max())
    total = 37 if slots == 1 else int(counts.sum(1).max())
    num_steps = -(-total // 64) * 64
    out_size = torch_coder.stream_out_size(total)
    ref_buf, ref_len = jax_coder.encode_core(
        *jax_coder.micro_ops_from_symbols(
            jnp.asarray(sym), jnp.asarray(idx), jt, slots, num_steps),
        out_size)
    ops = torch_coder.micro_ops_from_symbols(
        torch.as_tensor(sym), torch.as_tensor(idx), pt, slots, num_steps)
    buf, lens = torch_coder.encode_core(*ops, out_size)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-micro"
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))
    # The budgeted entry point takes the same arguments as the JAX jit.
    buf2, lens2 = torch_coder.encode_streams_budgeted(
        torch.as_tensor(sym), torch.as_tensor(idx), pt, slots, num_steps,
        out_size)
    jbuf2, jlen2 = jax_coder._encode_streams_jit(
        jnp.asarray(sym), jnp.asarray(idx), jt, slots, num_steps, out_size)
    np.testing.assert_array_equal(lens2.numpy(), np.asarray(jlen2))
    np.testing.assert_array_equal(buf2.numpy(), np.asarray(jbuf2))
    if slots > 1:
        gbuf, glen = cuda_coder.encode_gamma(
            torch.as_tensor(sym), torch.as_tensor(idx), cdf, meta, out_size)
        np.testing.assert_array_equal(lens.numpy(), glen.numpy())
        np.testing.assert_array_equal(buf.numpy(), gbuf.numpy())
        sbuf, slen = jax_coder.encode_streams(
            sym, jax_tables.parse_ragged_cdf(ragged), idx)
        np.testing.assert_array_equal(lens.numpy(), slen)
        np.testing.assert_array_equal(buf.numpy(), sbuf)


def test_encode_scan_checks_arguments():
    ops = [torch.zeros((4, 2), dtype=torch.int32) for _ in range(3)]
    mask = torch.ones((4, 2), dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_coder.encode_scan(*ops, mask, 9)  # < 2 * T + 2
    with pytest.raises(ValueError):
        cuda_coder.encode_scan(ops[0].long(), ops[1], ops[2], mask, 12)
    with pytest.raises(ValueError):
        cuda_coder.encode_scan(*ops, mask[:3], 12)
    with pytest.raises(ValueError):
        cuda_coder.encode_scan(*ops, mask.to(torch.uint8), 12)


# -- K8': the bucketed single-row decode ------------------------------------
def _single_row(precision, alphabet, alpha=1.2):
    pmf = 1.0 / (1 + np.arange(alphabet)) ** alpha
    pmf /= pmf.sum()
    return pmf, jax_tables.build_ragged_cdf(
        [jax_tables.pmf_to_quantized_cdf(pmf, precision)], [precision],
        [False])


def _corrupt(kind, buf, lens, rng):
    buf, lens = buf.copy(), lens.copy()
    if kind == "truncated":
        lens = lens // 2
    elif kind == "bitflip":
        for s in range(buf.shape[0]):
            pos = rng.randint(max(int(lens[s]), 1))
            buf[s, pos] ^= np.uint8(1 << rng.randint(8))
    elif kind == "random":
        buf = rng.randint(0, 256, buf.shape).astype(np.uint8)
    elif kind == "empty":
        lens = np.zeros_like(lens)
    cols = np.arange(buf.shape[1])[None, :]
    return np.where(cols < lens[:, None], buf, 0).astype(np.uint8), lens


def _decode_v1(ragged, buf, lens, n, precision):
    """pallas_coder.decode_scan_pallas (v1) in interpret mode."""
    t = jax_tables.parse_ragged_cdf(ragged)
    blast, win17 = jax_coder._bucketize_row(jnp.asarray(t.cdf[0], jnp.float32))
    sym, ok = pallas_coder.decode_scan_pallas(
        jnp.asarray(jax_coder.bytes_to_chunks(buf, lens)), jnp.asarray(lens),
        n, precision, t.cdf.shape[1] - 1,
        tuple(float(x) for x in np.asarray(blast)),
        tuple(tuple(float(x) for x in row) for row in np.asarray(win17)))
    return np.asarray(sym), np.asarray(ok)


K8_KINDS = ["none", "truncated", "bitflip", "random", "empty"]


@pytest.mark.parametrize("kind", K8_KINDS)
@pytest.mark.parametrize("precision,alphabet", [(12, 40), (15, 70), (16, 33)])
def test_bucketed_decode_matches_v1_kernel(interpret_pallas, precision,
                                           alphabet, kind):
    """K8' plain == decode_scan_pallas (v1, interpret mode): symbols and
    sanity flags on intact, truncated, bit-flipped, random and empty
    streams; and == K5' plain (decode_single_row) on all of them."""
    rng = np.random.RandomState(precision + K8_KINDS.index(kind))
    pmf, ragged = _single_row(precision, alphabet)
    n = 29
    sym = rng.choice(alphabet, size=(256, n), p=pmf).astype(np.int32)
    buf, lens = jax_coder.encode_streams(
        sym, jax_tables.parse_ragged_cdf(ragged))
    buf, lens = _corrupt(kind, buf, lens, rng)
    ref, ref_ok = _decode_v1(ragged, buf, lens, n, precision)
    _, pt = _tables(ragged)
    cdf, meta = pt.indexed_arrays()
    args = (torch.as_tensor(buf), torch.as_tensor(lens), n, cdf, meta)
    mine, ok = cuda_coder.decode_single_row_bucketed(
        *args[:3], *pt.bucketed_arrays())
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    k5, k5_ok = cuda_coder.decode_single_row(*args)
    np.testing.assert_array_equal(mine.numpy(), k5.numpy())
    np.testing.assert_array_equal(ok.numpy(), k5_ok.numpy())
    if kind == "none":
        np.testing.assert_array_equal(mine.numpy(), sym)
        assert bool(ok.all())


def test_bucketize_row_matches_jax():
    _, ragged = _single_row(13, 70)
    _, pt = _tables(ragged)
    row = pt.indexed_arrays()[0][0]
    blast, win17 = cuda_coder.bucketize_row(row)
    ref_blast, ref_win = jax_coder._bucketize_row(
        jnp.asarray(row.numpy(), jnp.float32))
    np.testing.assert_array_equal(blast.numpy(), np.asarray(ref_blast))
    np.testing.assert_array_equal(win17.numpy(), np.asarray(ref_win))


def test_bucketed_arrays_of_the_table():
    """DeviceCdfTable.bucketed_arrays: row 0 bucketized, its padded length
    less one and its precision, built once."""
    _, ragged = _single_row(13, 70)
    _, pt = _tables(ragged)
    blast, win17, max_pv, precision = pt.bucketed_arrays()
    ref_blast, ref_win = cuda_coder.bucketize_row(pt.indexed_arrays()[0][0])
    assert torch.equal(blast, ref_blast) and torch.equal(win17, ref_win)
    assert (max_pv, precision) == (pt.max_len - 1, 13)
    assert pt.bucketed_arrays() is pt.bucketed_arrays()


def test_bucketed_decode_checks_arguments():
    _, ragged = _single_row(12, 20)
    _, pt = _tables(ragged)
    blast, win17, max_pv, precision = pt.bucketed_arrays()
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    decode = cuda_coder.decode_single_row_bucketed
    decode(buf, lens, 4, blast, win17, max_pv, precision)
    with pytest.raises(ValueError):
        decode(buf, lens[:1], 4, blast, win17, max_pv, precision)
    with pytest.raises(ValueError):
        decode(buf, lens, 4, blast, win17[:, :16], max_pv, precision)
    with pytest.raises(ValueError):
        decode(buf, lens, 4, blast, win17, max_pv, 17)
    with pytest.raises(ValueError):
        decode(buf, lens, 4, blast, win17, 16 * blast.shape[0] + 1,
               precision)
    with pytest.raises(ValueError):
        decode(buf.int(), lens, 4, blast, win17, max_pv, precision)


def test_decode_streams_single_row_route():
    """decode_streams on a one-row table takes the single-row route and
    agrees with the bucketed decoder on the same streams."""
    pmf, ragged = _single_row(12, 40)
    _, pt = _tables(ragged)
    rng = np.random.RandomState(0)
    sym = rng.choice(40, size=(6, 20), p=pmf).astype(np.int32)
    buf, lens = torch_coder.encode_streams(torch.as_tensor(sym), pt)
    out, ok = torch_coder.decode_streams(buf, lens, 20, pt)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-single"
    np.testing.assert_array_equal(out.numpy(), sym)
    assert bool(ok.all())
    again, sane = cuda_coder.decode_single_row_bucketed(
        buf, lens, 20, *pt.bucketed_arrays())
    assert torch.equal(again, out) and torch.equal(sane, ok)


# -- K8''s kernel arithmetic: threshold, 32-bit counts, two-read window -------
M32 = 2 ** 32 - 1


def _windows(win17):
    """K8''s windows as the kernel stages them (int64 [nb, 20]): 0, the
    window's 17 entries, then 65536 twice.  The entries below a threshold
    are a prefix of the 17 (the row does not decrease), so with f of them
    the interval is (row[f], row[f + 1])."""
    win17 = win17.long()
    return torch.cat([torch.zeros_like(win17[:, :1]), win17,
                      torch.full_like(win17[:, :2], 1 << 16)], 1)


def _kernel_search(t, bucket_last, windows, max_pv):
    """Plain mirror of K8''s search for thresholds t (int64 [S], the output
    of ``single_row_threshold_plain``, which K5' and K8' share): (symbol,
    c_lo, c_hi) int64 [S].  The bucket count is #{b : bucket_last[b] < t};
    the window's count f is #{k : windows[b, 1 + k] < t} over its 17
    entries, and the interval (windows[b, f], windows[b, f + 1]) is read,
    not reduced over the window; the symbol min(16 nfull + max(f - 1, 0),
    max_pv) - 1."""
    bucket_last = bucket_last.long()
    num_buckets = bucket_last.shape[0]
    nfull = (bucket_last[None, :] < t[:, None]).sum(1)
    row = windows[nfull.clamp(max=num_buckets - 1)]
    f = (row[:, 1:18] < t[:, None]).sum(1)
    c_lo = row.gather(1, f[:, None])[:, 0]
    c_hi = row.gather(1, f[:, None] + 1)[:, 0]
    pv = (16 * nfull + (f - 1).clamp(min=0)).clamp(max=max_pv)
    return pv - 1, c_lo, c_hi


def _row_with_repeats(precision, length, seed):
    """A non-decreasing CDF row from 0 to 2^precision with repeated entries
    (zero-probability symbols), padded as a table pads it."""
    rng = np.random.RandomState(seed)
    top = 1 << precision
    inner = np.sort(rng.randint(0, top + 1, length - 2))
    inner[rng.rand(length - 2) < 0.3] = 0  # runs of zeros, sorted below
    row = np.concatenate([[0], np.sort(inner), [top]]).astype(np.int32)
    return torch.as_tensor(row)


def _bucketed(row):
    blast, win17 = cuda_coder.bucketize_row(row)
    max_pv = row.shape[0] - 1
    return blast, win17, _windows(win17), max_pv


def _check_states(offset, sm1, precision, row):
    """The mirror's step (threshold, bucket count, prefix count, two reads)
    against the exact products on decoder states (int64 [S] offsets value -
    base and sizes - 1); also the prefix claim: in every window the entries
    below the threshold come first."""
    blast, win17, windows, max_pv = _bucketed(row)
    size = sm1 + 1
    lower_bound = (offset + 1) << precision
    t = cuda_coder.single_row_threshold_plain(offset, sm1, precision)
    mine = _kernel_search(t, blast, windows, max_pv)
    exact = cuda_coder._bucketed_search_exact(size, lower_bound, blast,
                                              win17, max_pv)
    for a, b in zip(mine, exact):
        assert torch.equal(a, b)
    below = size[:, None, None] * win17.long()[None, :, :] < \
        lower_bound[:, None, None]
    assert bool((below[..., 1:] <= below[..., :-1]).all())
    full = size[:, None] * blast.long()[None, :] < lower_bound[:, None]
    assert bool((full[:, 1:] <= full[:, :-1]).all())


BUCKETED_ROWS = {
    1: [torch.tensor([0, 1, 2], dtype=torch.int32),
        torch.tensor([0, 0, 2, 2], dtype=torch.int32)],
    12: [_row_with_repeats(12, 258, 1), _row_with_repeats(12, 40, 2)],
    16: [_row_with_repeats(16, 1021, 3), _row_with_repeats(16, 34, 4),
         torch.tensor([0] * 20 + [65536] * 3, dtype=torch.int32)],
}


@pytest.mark.parametrize("precision", sorted(BUCKETED_ROWS))
@hypothesis.settings(max_examples=150, deadline=None, derandomize=True,
                     database=None)
@hypothesis.given(states=st.lists(st.tuples(st.integers(0, M32),
                                            st.integers(2 ** 16 - 1, M32)),
                                  min_size=1, max_size=64))
@hypothesis.example(states=[(2 ** 16 - 1, 2 ** 16 - 1), (0, 2 ** 16 - 1),
                            (M32, M32), (M32, 2 ** 16 - 1), (0, M32),
                            (2 ** 31, 2 ** 31)])
def test_bucketed_step_matches_exact_products(precision, states):
    """Any state a stream can reach, valid (offset <= size - 1, incl.
    offset = size - 1 and size = 2^16) or corrupt (offset past the size):
    the kernel's step equals the v1 kernel body's exact products, on rows
    with zero-probability symbols, and the entries below the threshold are
    a prefix of every window and of the bucket-last values."""
    offset = torch.tensor([s[0] for s in states], dtype=torch.int64)
    sm1 = torch.tensor([s[1] for s in states], dtype=torch.int64)
    for row in BUCKETED_ROWS[precision]:
        _check_states(offset, sm1, precision, row)
        valid = torch.minimum(offset, sm1)
        _check_states(valid, sm1, precision, row)


def _decode_both(buf, lens, n, row, precision, monkeypatch):
    """The mirror's and the exact plain version's symbols and flags, and
    the states the exact one met before each symbol.  The mirror is
    ``decode_single_row_bucketed_plain`` with its exact search replaced by
    the kernel's: the threshold from the same state, then
    ``_kernel_search``."""
    blast, win17, windows, max_pv = _bucketed(row)
    states = []
    exact = cuda_coder._bucketed_search_exact

    def kernel_step(size, lower_bound, *args):
        offset = (lower_bound >> precision) - 1
        t = cuda_coder.single_row_threshold_plain(offset, size - 1,
                                                  precision)
        return _kernel_search(t, blast, windows, max_pv)

    def recording(size, lower_bound, *args):
        states.append(((lower_bound >> precision) - 1, size - 1))
        return exact(size, lower_bound, *args)

    out = [torch.empty((buf.shape[0], n), dtype=torch.int32),
           torch.empty(buf.shape[0], dtype=torch.bool)]
    ref = [torch.empty_like(out[0]), torch.empty_like(out[1])]
    for search, result in ((kernel_step, out), (recording, ref)):
        monkeypatch.setattr(cuda_coder, "_bucketed_search_exact", search)
        cuda_coder.decode_single_row_bucketed_plain(
            buf, lens, blast, win17, max_pv, precision, *result)
    monkeypatch.undo()
    return out, ref, states


@pytest.mark.parametrize("kind", K8_KINDS)
@pytest.mark.parametrize("precision,alphabet",
                         [(1, 2), (12, 40), (15, 70), (16, 33)])
def test_bucketed_mirror_matches_exact_plain(monkeypatch, precision,
                                             alphabet, kind):
    """On the streams of test_bucketed_decode_matches_v1_kernel (the v1
    kernel's interpret-mode cases: intact, truncated, bit-flipped, random
    and empty), and at precision 1, the kernel's mirror gives the exact
    plain version's symbols and flags; the prefix claim holds on every
    state those streams reach."""
    rng = np.random.RandomState(precision + K8_KINDS.index(kind))
    pmf, ragged = _single_row(precision, alphabet)
    n = 29
    sym = rng.choice(alphabet, size=(256, n), p=pmf).astype(np.int32)
    buf, lens = jax_coder.encode_streams(
        sym, jax_tables.parse_ragged_cdf(ragged))
    buf, lens = _corrupt(kind, buf, lens, rng)
    _, pt = _tables(ragged)
    row = pt.indexed_arrays()[0][0]
    (out, ok), (ref, ref_ok), states = _decode_both(
        torch.as_tensor(buf), torch.as_tensor(lens), n, row, precision,
        monkeypatch)
    assert torch.equal(out, ref) and torch.equal(ok, ref_ok)
    if kind == "none":
        np.testing.assert_array_equal(out.numpy(), sym)
        assert bool(ok.all())
    offset = torch.cat([s[0] for s in states])
    sm1 = torch.cat([s[1] for s in states])
    _check_states(offset, sm1, precision, row)


@pytest.mark.parametrize("precision", [12, 16])
def test_bucketed_mirror_on_zero_probability_rows(monkeypatch, precision):
    """Random and bit-flipped streams on rows with repeated entries (the
    decode can land on a zero-probability symbol, an empty interval):
    mirror and exact plain version agree, symbols and flags."""
    rng = np.random.RandomState(precision)
    for row in BUCKETED_ROWS[precision]:
        buf = torch.as_tensor(rng.randint(0, 256, (48, 40)).astype(np.uint8))
        lens = torch.as_tensor(rng.randint(0, 41, 48).astype(np.int32))
        cols = torch.arange(40)[None, :]
        buf = torch.where(cols < lens[:, None].long(), buf, 0).to(torch.uint8)
        (out, ok), (ref, ref_ok), states = _decode_both(
            buf, lens, 30, row, precision, monkeypatch)
        assert torch.equal(out, ref) and torch.equal(ok, ref_ok)
        _check_states(torch.cat([s[0] for s in states]),
                      torch.cat([s[1] for s in states]), precision, row)
