"""The warp-per-stream indexed decode (K2, the native containers' sidecar
decode) on the CPU: its plain mirror ``decode_indexed_warp_plain`` -- the
plain decoder on the warp kernel's 16-bit table layout and lane-strided
search, escapes coming back as the marker -- against the JAX package's
``decode_streams_sidecar`` (intact, corrupt, short and odd streams) and
against ``decode_indexed_plain``, the cap of the symbol against the thread
kernel's, and the choice of the variant from the launch's shape.

Every comparison is exact: symbols and sanity flags are integers.
"""

import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from test_torch_warp_decode import (CORRUPTIONS, LAYOUT_CASES, STREAM_CASES,
                                    _corrupt, _layout_table, _quantized_ragged,
                                    _thresholds)

torch.set_num_threads(1)

# STREAM_CASES (one-level and two-level rows, precision 5-16, values up to
# the int32 extremes) and rows at precision 1 to 4: name -> (alphabet
# sizes, precisions, overflow flags, streams, symbols, Laplace scale).  (In
# the ragged format a bounded row's precision must differ from the
# terminal value of the row before it.)
CASES = dict(STREAM_CASES, low_precision=(
    [2, 2, 3, 4, 5], [1, 2, 2, 3, 4], [True, True, True, False, True], 5, 75,
    2.0))


def _case(name):
    rng = np.random.RandomState(sorted(CASES).index(name) + 30)
    alphabets, precs, ovfs, s, n, scale = CASES[name]
    ragged = _quantized_ragged(rng, alphabets, precs, ovfs)
    idx = rng.randint(0, len(alphabets), (s, n)).astype(np.int32)
    sym = np.round(rng.laplace(0, scale, (s, n))).astype(np.int32)
    if name == "extremes":
        sym[:, 3] = [-2 ** 31, 2 ** 31 - 1, -(2 ** 20), 2 ** 20 + 3, 2 ** 30,
                     -(2 ** 31 - 1), 2 ** 31 - 2, -1]
    return ragged, sym, idx


def _tables(ragged):
    jt = jax_tables.parse_ragged_cdf(ragged)
    return jt, torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                          "cpu")


def _both(buf, lens, idx, table):
    """(warp mirror, thread plain) results of K2 on the CPU."""
    cdf, meta = table.indexed_arrays()
    args = (torch.as_tensor(np.array(buf)), torch.as_tensor(np.array(lens)),
            torch.as_tensor(np.array(idx)), cdf, meta)
    return (cuda_coder.decode_indexed_warp(*args, table.warp_arrays()),
            cuda_coder.decode_indexed_thread(*args))


def _no_sidecar():
    return np.zeros((0, 2), np.int32), np.zeros((0,), np.int32)


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_indexed_warp_mirror_matches_jax_sidecar_decode(name, kind):
    """Streams the JAX package encodes in the sidecar format decode
    through the warp mirror to decode_streams_sidecar's symbols (the
    escape marker where an escape was) and sanity flags, and to
    decode_indexed_plain's; intact ones with the sidecar applied give the
    symbols back on the overflow rows."""
    ragged, sym, idx = _case(name)
    rng = np.random.RandomState(CORRUPTIONS.index(kind))
    jt, table = _tables(ragged)
    buf, lens, esc_pos, esc_val = jax_coder.encode_streams_sidecar(
        sym, jt, idx)
    buf, lens = _corrupt(kind, np.asarray(buf), np.asarray(lens), rng)
    ref, ref_ok = jax_coder.decode_streams_sidecar(
        buf, lens, sym.shape[1], jt, *_no_sidecar(), indexes=idx)
    (mine, ok), (plain, plain_ok) = _both(buf, lens, idx, table)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert torch.equal(mine, plain) and torch.equal(ok, plain_ok)
    if kind == "none":
        assert bool(ok.all())
        back = torch_coder.sidecar_apply(
            mine, torch.as_tensor(torch_coder.sidecar_flatten(
                esc_pos, *sym.shape)), torch.as_tensor(esc_val))
        ovf = np.asarray(jt.overflow)[idx]
        np.testing.assert_array_equal(back.numpy()[ovf], sym[ovf])


def test_indexed_warp_mirror_markers_at_window_edges():
    """Escapes in lane 0 and lane 31 of a window of 32 symbols, several in
    one window, back to back across a window's end and in the last,
    partial window, on one-level and two-level rows: the marker comes back
    at each."""
    ragged, _, _ = _case("two_level")
    jt, table = _tables(ragged)
    rng = np.random.RandomState(5)
    s, n = 4, 75
    idx = rng.randint(0, 4, (s, n)).astype(np.int32)
    marker = np.asarray(jt.length)[idx] - 2
    sym = rng.randint(0, 3, (s, n)).astype(np.int32)
    at = [0, 31, 32, 33, 63, 64, 70, 74]
    sym[:, at] = np.where(np.arange(s)[:, None] % 2, -7, marker[:, at] + 9)
    ovf = np.asarray(jt.overflow)[idx]
    buf, lens, _, _ = jax_coder.encode_streams_sidecar(sym, jt, idx)
    ref, ref_ok = jax_coder.decode_streams_sidecar(
        buf, lens, n, jt, *_no_sidecar(), indexes=idx)
    (mine, ok), (plain, _) = _both(buf, lens, idx, table)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert torch.equal(mine, plain) and bool(ok.all())
    escaped = ovf[:, at]
    assert escaped.sum() >= 8
    np.testing.assert_array_equal(mine.numpy()[:, at][escaped],
                                  marker[:, at][escaped])


@pytest.mark.parametrize("byte_len", [0, 1, 2, 3, 41])
def test_indexed_warp_mirror_short_and_odd_buffers(byte_len):
    """Streams of 0, 1, 2, 3 bytes and one as long as an odd buffer width:
    bytes at or past the length read as zero, whatever the buffer holds."""
    ragged, sym, idx = _case("short_rows")
    rng = np.random.RandomState(byte_len + 7)
    jt, table = _tables(ragged)
    buf = rng.randint(0, 256, (sym.shape[0], 41)).astype(np.uint8)
    lens = np.full(sym.shape[0], byte_len, np.int32)
    zeroed = np.where(np.arange(41)[None, :] < byte_len, buf, 0).astype(
        np.uint8)
    ref, ref_ok = jax_coder.decode_streams_sidecar(
        zeroed, lens, sym.shape[1], jt, *_no_sidecar(), indexes=idx)
    (mine, ok), (plain, plain_ok) = _both(buf, lens, idx, table)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert torch.equal(mine, plain) and torch.equal(ok, plain_ok)


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_indexed_symbol_cap_agrees_with_thread_kernel(name):
    """The warp kernel returns the count capped at the row's limit, the
    thread kernel at max_len - 2: the two agree for thresholds at, just
    below and just above every entry of (up to eight) rows, because no
    limit exceeds max_len - 2; on a table parsed from the ragged format
    every limit is the row's escape marker length - 2."""
    table = _layout_table(name)
    cdf, meta = table.indexed_arrays()
    num_rows, max_len = cdf.shape
    search = cuda_coder._WarpSearch(table.warp_arrays(), num_rows, max_len)
    limit = search.meta[:, 3]
    assert int(limit.max()) <= max_len - 2
    if LAYOUT_CASES[name] == "golden":
        assert torch.equal(limit, torch.as_tensor(
            np.asarray(table.host.length) - 2, dtype=torch.int64))
    row, size, off = _thresholds(cdf[:8], meta[:8], (1 << 32, 0x9E3779B1))
    prec = meta[:, 1].long()[row]
    lower_bound = (off + 1) << prec
    warp_count = search(row, size, lower_bound)[0]
    dense_count = cuda_coder._dense_search(cdf.long()[row], size,
                                           lower_bound)[0]
    assert torch.equal(warp_count, dense_count.clamp(max=max_len - 2))


@pytest.mark.parametrize("streams,variant", [(3, "warp"), (4, "warp"),
                                             (5, "thread")])
def test_indexed_variant_follows_the_stream_count(monkeypatch, streams,
                                                  variant):
    """decode_indexed picks its variant from the number of streams alone:
    at most WARP_DECODE_MAX_STREAMS take the warp variant.  Both give the
    same symbols through the front end's sidecar decode."""
    ragged, sym, idx = _case("short_rows")
    reps = -(-streams // sym.shape[0])
    sym = np.tile(sym, (reps, 1))[:streams]
    idx = np.tile(idx, (reps, 1))[:streams]
    took = []
    for fn in ("decode_indexed_warp_plain", "decode_indexed_plain"):
        orig = getattr(cuda_coder, fn)

        def spy(*args, _orig=orig, _fn=fn):
            took.append(_fn)
            return _orig(*args)

        monkeypatch.setattr(cuda_coder, fn, spy)
    monkeypatch.setattr(cuda_coder, "WARP_DECODE_MAX_STREAMS", 4)
    jt, table = _tables(ragged)
    sym_t, idx_t = torch.as_tensor(sym), torch.as_tensor(idx)
    buf, lens = torch_coder.encode_dispatch(sym_t, table,
                                            torch_coder.stream_out_size(
                                                sym.shape[1]), idx_t)
    out, ok = torch_coder.decode_dispatch(buf, lens, sym.shape[1], table,
                                          idx_t)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"
    assert took == ["decode_indexed_warp_plain" if variant == "warp"
                    else "decode_indexed_plain"]
    marker = np.asarray(jt.length)[idx] - 2
    ovf = np.asarray(jt.overflow)[idx]
    expect = np.where(ovf & ((sym < 0) | (sym >= marker)), marker, sym)
    np.testing.assert_array_equal(out.numpy()[ovf], expect[ovf])
    assert bool(ok.all())
    assert cuda_coder.LAUNCHES_WARP["decode_indexed"] == 0  # no kernel here


def test_layout_of_another_table_is_refused():
    ragged, _, _ = _case("short_rows")
    _, table = _tables(ragged)
    cdf, meta = table.indexed_arrays()
    args = (torch.zeros((1, 8), dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32), cdf, meta)
    with pytest.raises(ValueError, match="layout"):
        cuda_coder.decode_indexed_warp(*args, table.warp_arrays()[:-8])
    with pytest.raises(ValueError, match="layout"):
        cuda_coder.decode_indexed_warp(*args, table.warp_arrays().int())
