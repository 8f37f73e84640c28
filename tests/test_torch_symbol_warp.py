"""The warp-per-stream kernels of the symbol encoders K6' (``encode_gamma``,
the reference .tfci format) and K1 (``encode_indexed``, the sidecar format)
on the CPU: their plain mirrors ``cuda_coder.encode_gamma_warp_plain`` and
``encode_indexed_warp_plain`` -- windows of 32 symbols, the ballot of a
window's escapes, the micro-op scan's full window where no symbol escapes,
symbol by symbol with each escape's Elias-gamma steps in place elsewhere,
the drain points, the 64 held chunks, Finalize -- against the JAX package's
``jax_coder.encode_streams`` and ``encode_streams_sidecar`` and the
reference coder's golden bytes; and the wrappers' choice on the CPU.

Every comparison is exact: the coder has no tolerance.  The JAX encoders
run their XLA scan on the CPU, as the JAX package's own tests run them.
The inputs come from tests/symbol_cases.py, which test_torch_cuda.py and
chip_smoke.py use too.
"""

import os

import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from symbol_cases import SYMBOL_CASES, short_row_case, symbol_case

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def _port(ragged, sym, idx):
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    cdf, meta = table.indexed_arrays()
    return torch.as_tensor(sym), torch.as_tensor(idx), cdf, meta


def _run(fn, args, width):
    """``fn`` (a mirror or a plain version) into rows of ``width`` bytes
    prefilled with noise."""
    sym = args[0]
    out = torch.full((sym.shape[0], width), 0xAB, dtype=torch.uint8)
    lens = torch.full((sym.shape[0],), -1, dtype=torch.int32)
    fn(*args, out, lens)
    return out.numpy(), lens.numpy()


@pytest.mark.parametrize("name", sorted(SYMBOL_CASES))
def test_gamma_mirror_matches_jax(name):
    """K6''s warp mirror writes jax_coder.encode_streams' padded arrays
    and lengths (escapes in lane 0 and 31, several in a window, in the last
    partial window, negative, g = 2^31 back to back; streams of 0, 1, 31,
    32, 33, 65 and more symbols; bounded rows at precision 1 to 16), and
    equals encode_gamma_plain."""
    ragged, sym, idx = symbol_case(name)
    ref_buf, ref_lens = jax_coder.encode_streams(
        sym, jax_tables.parse_ragged_cdf(ragged), idx)
    args = _port(ragged, sym, idx)
    buf, lens = _run(cuda_coder.encode_gamma_warp_plain, args,
                     ref_buf.shape[1])
    np.testing.assert_array_equal(lens, ref_lens)
    np.testing.assert_array_equal(buf, ref_buf)
    plain = _run(cuda_coder.encode_gamma_plain, args, ref_buf.shape[1])
    np.testing.assert_array_equal(buf, plain[0])
    np.testing.assert_array_equal(lens, plain[1])


@pytest.mark.parametrize("name", sorted(SYMBOL_CASES))
def test_indexed_mirror_matches_jax_sidecar(name):
    """K1's warp mirror writes jax_coder.encode_streams_sidecar's bytes
    and lengths (escapes as the bare marker, bounded rows clipped), and
    equals encode_indexed_plain."""
    ragged, sym, idx = symbol_case(name)
    ref_buf, ref_lens, _, _ = jax_coder.encode_streams_sidecar(
        sym, jax_tables.parse_ragged_cdf(ragged), idx)
    args = _port(ragged, sym, idx)
    buf, lens = _run(cuda_coder.encode_indexed_warp_plain, args,
                     ref_buf.shape[1])
    np.testing.assert_array_equal(lens, ref_lens)
    np.testing.assert_array_equal(buf, ref_buf)
    plain = _run(cuda_coder.encode_indexed_plain, args, ref_buf.shape[1])
    np.testing.assert_array_equal(buf, plain[0])
    np.testing.assert_array_equal(lens, plain[1])


def _golden_names():
    gold = np.load(GOLDEN)
    return sorted({k.rsplit("__", 1)[0] for k in gold.files
                   if k.endswith("__cdf")})


@pytest.mark.parametrize("name", _golden_names())
def test_golden_cases_through_gamma_mirror(name):
    """Every case of golden.npz (carry_p16, short_*, dirac_*, uniform_*,
    zipf_*, mixed_prec) through K6''s warp mirror on its one-row table:
    the reference coder's bytes, zero after them, in a row of even and of
    odd width."""
    gold = np.load(GOLDEN)
    prec = int(gold[f"{name}__precision"])
    ragged = tables.build_ragged_cdf([gold[f"{name}__cdf"]], [prec], [False])
    sym = gold[f"{name}__data"].astype(np.int32)[None]
    args = _port(ragged, sym, np.zeros_like(sym))
    ref = gold[f"{name}__bytes"].tobytes()
    for width in (2 * sym.shape[1] + 2, 2 * sym.shape[1] + 7):
        buf, lens = _run(cuda_coder.encode_gamma_warp_plain, args, width)
        assert int(lens[0]) == len(ref)
        assert buf[0, : len(ref)].tobytes() == ref
        assert not buf[0, len(ref):].any()


@pytest.mark.parametrize("slack", [0, 41])
@pytest.mark.parametrize("name", ["placements", "all_escapes"])
def test_gamma_mirror_cuts_a_short_row(name, slack):
    """Rows of 2 N + 2 + ``slack`` bytes, too short for some streams'
    Elias-gamma steps, in one launch with escape-free streams beside each
    escaping one: K6''s warp mirror reports every stream that could pass
    its row (2 T + 2 bytes, T its coded intervals) as cut, length row + 1,
    and writes every other stream's bytes as encode_gamma_plain does in a
    row long enough."""
    ragged, sym, idx = short_row_case(name)
    args = _port(ragged, sym, idx)
    steps = cuda_coder.interval_counts(*args[:2], args[3])[0].sum(1).numpy()
    width = 2 * sym.shape[1] + 2 + slack
    cut = 2 * steps + 2 > width
    assert cut.any() and not cut.all()
    ref_buf, ref_lens = _run(cuda_coder.encode_gamma_plain, args,
                             2 * int(steps.max()) + 2)
    buf, lens = _run(cuda_coder.encode_gamma_warp_plain, args, width)
    np.testing.assert_array_equal(lens[cut], width + 1)
    np.testing.assert_array_equal(lens[~cut], ref_lens[~cut])
    np.testing.assert_array_equal(buf[~cut], ref_buf[~cut, :width])
    assert not ref_buf[~cut, width:].any()


def test_gamma_steps_are_the_reference_order():
    """The mirror's Elias-gamma steps of one escape are
    jax_coder.micro_ops_from_symbols' slots 1 ... 2 nbits + 2: nbits zeros,
    the bits of g from the top one down, the sign."""
    class Record:
        def __init__(self):
            self.ops = []

        def step(self, op):
            self.ops.append(op)

        def drain(self):
            pass

    for g, neg in ((1, 0), (2, 1), (5, 0), (2 ** 31, 1), (2 ** 31 - 7, 0)):
        rec = Record()
        cuda_coder._gamma_steps(rec, g, neg)
        nbits = g.bit_length() - 1
        bits = [0] * nbits + [(g >> k) & 1 for k in range(nbits, -1, -1)] \
            + [neg]
        assert rec.ops == [cuda_coder.scan_op(b, b + 1, 1) for b in bits]


@pytest.mark.parametrize("variant", ["", "_warp", "_thread"])
@pytest.mark.parametrize("name", ["encode_gamma", "encode_indexed"])
def test_cpu_wrappers_run_the_plain_version(name, variant):
    """On CPU tensors every wrapper of K6' and K1 runs the plain version
    and launches nothing; the warp kernel's mirror gives the same bytes;
    a row too short for the symbols is refused."""
    ragged, sym, idx = symbol_case("placements")
    args = _port(ragged, sym, idx)
    width = 2 * int(cuda_coder.interval_counts(*args[:2], args[3])[0].sum(
        1).max()) + 3
    before = dict(cuda_coder.LAUNCHES), dict(cuda_coder.LAUNCHES_WARP)
    buf, lens = getattr(cuda_coder, name + variant)(*args, width)
    assert (dict(cuda_coder.LAUNCHES), dict(cuda_coder.LAUNCHES_WARP)) == \
        before
    plain = _run(getattr(cuda_coder, name + "_plain"), args, width)
    mirror = _run(getattr(cuda_coder, name + "_warp_plain"), args, width)
    for ref in (plain, mirror):
        np.testing.assert_array_equal(buf.numpy(), ref[0])
        np.testing.assert_array_equal(lens.numpy(), ref[1])
    with pytest.raises(ValueError):
        getattr(cuda_coder, name + variant)(*args, 2 * sym.shape[1] + 1)


def test_dispatch_by_stream_count(monkeypatch):
    """encode_gamma and encode_indexed pick their kernel by the stream
    count alone, at the encoders' dispatch constant, WARP_ENCODE_MAX_STREAMS
    (16384, where chip_smoke.py's sweep puts the crossover); every warp
    launch is counted."""
    assert cuda_coder.WARP_ENCODE_MAX_STREAMS == 16384
    assert set(cuda_coder.LAUNCHES_WARP) == {
        "decode_indexed", "decode_gamma", "encode_scan", "encode_gamma",
        "encode_indexed"}
    taken = []
    for name in ("encode_gamma", "encode_indexed"):
        for variant in ("warp", "thread"):
            monkeypatch.setattr(cuda_coder, f"{name}_{variant}",
                                lambda *a, v=variant: taken.append(v))
    edge = cuda_coder.WARP_ENCODE_MAX_STREAMS
    for streams in (1, edge, edge + 1):
        sym = torch.zeros((streams, 1), dtype=torch.int32)
        for name in ("encode_gamma", "encode_indexed"):
            getattr(cuda_coder, name)(sym, sym, None, None, 4)
    assert taken == ["warp"] * 4 + ["thread"] * 2
