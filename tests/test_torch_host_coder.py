"""The port's host C coder (codec/host.py over native/range_coder.cc), its
Python oracle (codec/stream.py) and its scalar coder (codec/reference.py)
against the reference coder's golden bytes and the JAX package's oracle.

Bytes, decoded symbols and sanity flags are compared exactly:
  * every case of tests/golden/golden.npz (the reference C++ coder's bytes;
    mixed_prec as channel mode over its two rows);
  * tests/test_host_codec.py's fuzz cases (channel and indexed mode,
    escapes) and its multithreaded-determinism case, against
    compression_tpu.codec.stream;
  * tests/test_corrupt.py's corrupt, empty and tiny strings, the runaway
    escape and the zero-filled streams, decoded by the host coder, the
    port's oracle and the JAX package's oracle;
  * scalar round trips of reference.py against the JAX package's;
and a build that cannot run raises instead of falling back.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from compression_tpu import distributions as jax_dist
from compression_tpu.codec import reference as jax_reference
from compression_tpu.codec import stream as jax_stream
from compression_tpu.codec import tables as jax_tables
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel
from compression_tpu_torch import native
from compression_tpu_torch.codec import host, reference, stream, tables

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def _golden_names():
    gold = np.load(GOLDEN)
    return sorted({k.rsplit("__", 1)[0] for k in gold.files})


def _golden_case(name):
    """(ragged table, symbols [1, N], reference bytes); mixed_prec codes
    its steps alternately at precision 16 and 4 (tests/golden/
    make_golden.py), which channel mode over two rows reproduces."""
    gold = np.load(GOLDEN)
    data = gold[f"{name}__data"].astype(np.int32)[None]
    if name == "mixed_prec":
        cdf16 = tables.pmf_to_quantized_cdf(np.array([.7, .1, .1, .1]), 16)
        cdf4 = tables.pmf_to_quantized_cdf(np.full(4, 0.25), 4)
        ragged = tables.build_ragged_cdf([cdf16, cdf4], [16, 4],
                                         [False, False])
    else:
        ragged = tables.build_ragged_cdf(
            [gold[f"{name}__cdf"]], [int(gold[f"{name}__precision"])],
            [False])
    return ragged, data, gold[f"{name}__bytes"].tobytes()


@pytest.mark.parametrize("name", _golden_names())
def test_golden_bytes(name):
    """Host coder and oracle write the reference coder's bytes and decode
    them back with the sanity check passing."""
    ragged, data, ref = _golden_case(name)
    t = tables.parse_ragged_cdf(ragged)
    assert host.encode_streams(data, t) == [ref]
    assert stream.encode_streams(data, t) == [ref]
    for decode in (host.decode_streams, stream.decode_streams):
        values, sanity = decode([ref], data.shape[1], t)
        np.testing.assert_array_equal(values, data)
        assert sanity.tolist() == [True]


def _random_ragged(rng, num_rows, overflow_p=0.5, max_prec=16):
    """tests/test_host_codec.py's random table, as the ragged format."""
    cdfs, precs, ovfs = [], [], []
    for _ in range(num_rows):
        prec = int(rng.randint(1, max_prec + 1))
        ovf = bool(rng.rand() < overflow_p)
        alpha = int(rng.randint(1 if ovf else 2, min(1 << prec, 40) + 1))
        alpha = max(alpha, 1 if ovf else 2)
        pmf = rng.dirichlet(np.ones(alpha))
        cdfs.append(tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
        ovfs.append(ovf)
    return tables.build_ragged_cdf(cdfs, precs, ovfs)


def _check_against_jax(ragged, sym, idx, **host_kwargs):
    """Host coder == port oracle == JAX oracle, both directions."""
    t = tables.parse_ragged_cdf(ragged)
    jt = jax_tables.parse_ragged_cdf(ragged)
    ref = jax_stream.encode_streams(sym, jt, idx)
    assert host.encode_streams(sym, t, idx, **host_kwargs) == ref
    assert stream.encode_streams(sym, t, idx) == ref
    n = sym.shape[1]
    want, want_ok = jax_stream.decode_streams(ref, n, jt, idx)
    for got, got_ok in (host.decode_streams(ref, n, t, idx, **host_kwargs),
                        stream.decode_streams(ref, n, t, idx)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(want, sym)
    assert want_ok.all()


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_matches_jax_oracle(seed):
    """tests/test_host_codec.py's fuzz cases: random tables at precision
    1-16 with overflow rows, channel or indexed mode, escapes."""
    rng = np.random.RandomState(seed)
    num_rows = int(rng.randint(1, 5))
    ragged = _random_ragged(rng, num_rows)
    t = tables.parse_ragged_cdf(ragged)
    s, n = int(rng.randint(1, 9)), int(rng.randint(1, 40))
    indexed = bool(rng.rand() < 0.5)
    idx = rng.randint(0, num_rows, size=(s, n)).astype(np.int32) \
        if indexed else None
    rows = idx if idx is not None else np.broadcast_to(
        np.arange(n) % num_rows, (s, n))
    mv = np.asarray(t.length, np.int64)[rows] - 2
    sym = rng.randint(-5, 50, size=(s, n)).astype(np.int32)
    # Bounded rows take values in range; overflow rows take anything.
    sym = np.where(np.asarray(t.overflow)[rows], sym,
                   np.abs(sym) % np.maximum(mv, 1)).astype(np.int32)
    _check_against_jax(ragged, sym, idx)


@pytest.mark.parametrize("num_threads", [1, 8])
def test_multithreaded_determinism(num_threads):
    """tests/test_host_codec.py's 64 x 100 streams: the same bytes on one
    thread and on eight, equal to the JAX oracle's."""
    rng = np.random.RandomState(99)
    ragged = _random_ragged(rng, 3, overflow_p=0.0)
    t = tables.parse_ragged_cdf(ragged)
    rows = np.broadcast_to(np.arange(100) % 3, (64, 100))
    sym = (rng.randint(0, 1000, size=(64, 100))
           % np.maximum(np.asarray(t.length, np.int64)[rows] - 1, 1)).astype(
               np.int32)
    _check_against_jax(ragged, sym, None, num_threads=num_threads)


# -- corrupt, empty and tiny strings (tests/test_corrupt.py) ---------------
def _corrupt_em_cases():
    """test_corrupt.py's TestEntropyModelLayer inputs: the 40 corrupted
    string lists of a NoisyNormal model's (8, 40) tensor, then the empty
    and tiny payloads; with the model's one-row table."""
    em = ContinuousBatchedEntropyModel(
        prior=jax_dist.NoisyNormal(loc=0.0, scale=1.0), coding_rank=1,
        compression=True)
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.normal(0, 1, (8, 40)), jnp.float32)
    strings = em.compress_to_strings(x)
    cases = []
    for case in range(40):
        bad = list(strings)
        k = case % len(bad)
        s = bytearray(bad[k])
        if case % 3 == 0 and len(s) > 2:
            s[rng.randint(len(s))] ^= 1 << rng.randint(8)
            bad[k] = bytes(s)
        elif case % 3 == 1:
            bad[k] = bytes(s[: max(len(s) // 2, 1)])
        else:
            bad[k] = bytes(rng.randint(0, 256, max(len(s), 1))
                           .astype(np.uint8))
        cases.append(bad)
    cases += [[b""] * 4, [b"\x00"] * 4, [b"\xff"] * 4, [b"\xff" * 3] * 4]
    return np.asarray(em.cdf), cases


def _indexed_ragged():
    """test_corrupt.py's _table_indexed: 8 overflow rows at precision 10."""
    rng = np.random.RandomState(5)
    cdfs = []
    for r in range(8):
        pmf = rng.dirichlet(np.ones(4 + 3 * r)).astype(np.float32) * (
            1 - 2.0 ** -8)
        cdfs.append(tables.pmf_to_quantized_cdf(pmf, 10))
    return tables.build_ragged_cdf(cdfs, [10] * 8, [True] * 8)


def _decode_all(strings, n, ragged, idx):
    """(values, sanity) of the host coder, the port oracle and the JAX
    oracle."""
    t = tables.parse_ragged_cdf(ragged)
    return (host.decode_streams(strings, n, t, idx),
            stream.decode_streams(strings, n, t, idx),
            jax_stream.decode_streams(
                strings, n, jax_tables.parse_ragged_cdf(ragged), idx))


def _assert_same(results):
    (hv, hs), (sv, ss), (jv, js) = results
    np.testing.assert_array_equal(hv, jv)
    np.testing.assert_array_equal(sv, jv)
    np.testing.assert_array_equal(hs, js)
    np.testing.assert_array_equal(ss, js)
    return js


def test_corrupt_em_strings_decode_as_jax():
    """The 40 corrupted string lists and the four empty / tiny payloads:
    symbols and sanity flags equal the JAX oracle's; the flags fire."""
    ragged, cases = _corrupt_em_cases()
    flagged = 0
    for strings in cases:
        sanity = _assert_same(_decode_all(strings, 40, ragged, None))
        flagged += int((~sanity).sum())
    assert flagged > 0


def test_corrupt_indexed_gamma_streams_decode_as_jax():
    """test_corrupt.py's indexed in-stream-gamma fuzz: bit flips and noise
    over 16 streams of 48 symbols with 5% escapes, 48 cases."""
    ragged = _indexed_ragged()
    t = tables.parse_ragged_cdf(ragged)
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 8, (16, 48)).astype(np.int32)
    mv = t.length[idx] - 2
    sym = (rng.randint(0, 1000, (16, 48)) % np.maximum(mv, 1)).astype(
        np.int32)
    sym[rng.rand(16, 48) < 0.05] = 200
    strings = host.encode_streams(sym, t, idx)
    assert strings == jax_stream.encode_streams(
        sym, jax_tables.parse_ragged_cdf(ragged), idx)
    for case in range(48):
        bad = []
        for s in strings:
            b = bytearray(s)
            if case % 2 == 0:
                for _ in range(1 + case // 4):
                    if b:
                        b[rng.randint(len(b))] ^= 1 << rng.randint(8)
            else:
                b = bytearray(rng.randint(0, 256, len(b)).astype(np.uint8))
            bad.append(bytes(b))
        _assert_same(_decode_all(bad, 48, ragged, idx))


def test_runaway_escape_and_zero_tails_decode_as_jax():
    """The crafted stream of an escape followed by 70 unary zeros (the
    decoder caps the unary run and flags the stream), and all-zero streams
    of 1-64 bytes for 1 and 4 symbols."""
    ragged = _indexed_ragged()
    t = tables.parse_ragged_cdf(ragged)
    cdf = t.cdf[0][: int(t.length[0])]
    enc = reference.RangeEncoder()
    sink = bytearray()
    enc.encode(int(cdf[-2]), int(cdf[-1]), 10, sink)
    for _ in range(70):
        enc.encode(0, 1, 1, sink)
    enc.finalize(sink)
    sanity = _assert_same(_decode_all([bytes(sink)], 1, ragged,
                                      np.zeros((1, 1), np.int32)))
    assert not sanity[0]
    for n in (1, 2, 8, 64):
        for nelem in (1, 4):
            _assert_same(_decode_all([bytes(n)], nelem, ragged,
                                     np.zeros((1, nelem), np.int32)))


@pytest.mark.parametrize("seed", range(4))
def test_reference_round_trip_matches_jax(seed):
    """Scalar coder: a random mix of intervals at precision 1-16 and
    overflow-coded values (escapes of every size up to 2^30) encodes to the
    JAX reference's bytes, and both decoders read back the same symbols
    and finalize flags."""
    rng = np.random.RandomState(seed)
    ragged = _random_ragged(rng, 6, overflow_p=0.5)
    t = tables.parse_ragged_cdf(ragged)
    ops = []
    for _ in range(400):
        row = int(rng.randint(t.num_rows))
        n = int(t.length[row])
        if t.overflow[row]:
            value = int(rng.randint(-3, n + 2)) if rng.rand() < 0.8 else \
                int(rng.choice([-1, 1]) * (1 << rng.randint(1, 31)))
        else:
            value = int(rng.randint(0, n - 1))
        ops.append((row, value))
    sinks = []
    for mod in (reference, jax_reference):
        enc = mod.RangeEncoder()
        sink = bytearray()
        for row, value in ops:
            cdf = t.cdf[row, : t.length[row]]
            prec = int(t.precision[row])
            if t.overflow[row]:
                mod.overflow_encode(enc, sink, cdf, prec, value)
            else:
                enc.encode(int(cdf[value]), int(cdf[value + 1]), prec, sink)
        enc.finalize(sink)
        sinks.append(bytes(sink))
    assert sinks[0] == sinks[1]
    for mod in (reference, jax_reference):
        dec = mod.RangeDecoder(sinks[0])
        got = []
        for row, _ in ops:
            cdf = t.cdf[row, : t.length[row]]
            prec = int(t.precision[row])
            got.append(mod.overflow_decode(dec, cdf, prec)
                       if t.overflow[row] else dec.decode(cdf, prec))
        assert got == [v for _, v in ops]
        assert dec.finalize()


def test_failed_build_raises(monkeypatch, tmp_path):
    """No g++ on the path, then a compiler that fails: the host coder
    raises (no fallback to the oracle), and available() says False."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_RC_LIB", None)
    sym = np.zeros((1, 3), np.int32)
    ragged = tables.build_ragged_cdf([[0, 1 << 11, 1 << 12]], [12], [False])
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.get_range_coder_lib()
    with pytest.raises(RuntimeError):
        host.encode_streams(sym, ragged)
    with pytest.raises(RuntimeError):
        host.decode_streams([b""], 3, ragged)
    assert not host.available()
    monkeypatch.setattr(native.shutil, "which", lambda name: "false")
    with pytest.raises(RuntimeError, match="build of range_coder.so failed"):
        native.get_range_coder_lib()
    assert native._RC_LIB is None
    assert not list(tmp_path.iterdir())
