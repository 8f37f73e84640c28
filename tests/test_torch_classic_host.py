"""The classic (.tfci) containers and the host C coder.

The coder front end takes no host route: a reference-format call launches
its kernel on CUDA tensors, and runs its plain version on CPU tensors,
whatever its stream count (the JAX package's ``CTPU_HOST_ROUTE_MAX_STREAMS``
does nothing here).  The host C coder (``codec/host.py``) is an entry
point of its own, for a machine without a card: it writes and reads the
same streams.  Checked here: the golden bytes, the JAX package's
encode_streams / decode_streams on corrupt streams, the entropy models'
classic strings (ms2020's ``loc`` included), and the classic containers of
bls2017, bmshj2018 and ms2020 with the front end's reference-format calls
served by the host coder.

Every comparison is exact: the coder has no tolerance.
"""

import os

import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import host, tables, torch_coder
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.entropy_models.continuous_indexed import (
    LocationScaleIndexedEntropyModel)
from compression_tpu_torch.models import bls2017, bmshj2018, ms2020
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def _np(t):
    return None if t is None else np.asarray(t, np.int32)


def _host_encode(symbols, table, indexes=None):
    """The front end's reference-format encode, served by the host coder."""
    strings = host.encode_streams(_np(symbols), table.host, _np(indexes))
    buf, lens = torch_coder.from_bytes_list(strings)
    return torch.as_tensor(buf), torch.as_tensor(lens)


def _host_decode(buf, lens, num_elements, table, indexes=None):
    """The front end's reference-format decode, served by the host coder."""
    strings = torch_coder.to_bytes_list(np.asarray(buf), np.asarray(lens))
    sym, ok = host.decode_streams(strings, int(num_elements), table.host,
                                  _np(indexes))
    return torch.as_tensor(sym), torch.as_tensor(ok)


# -- no route ------------------------------------------------------------------
@pytest.mark.parametrize("limit", [None, "0", "1", "1000"])
def test_front_end_takes_no_host_route(monkeypatch, limit):
    """A one-stream call runs the kernels' plain versions on the CPU,
    whatever the JAX package's knob says; the front end has no route."""
    if limit is None:
        monkeypatch.delenv("CTPU_HOST_ROUTE_MAX_STREAMS", raising=False)
    else:
        monkeypatch.setenv("CTPU_HOST_ROUTE_MAX_STREAMS", limit)
    assert not hasattr(torch_coder, "_host_route")
    table = _port_table(_mixed(np.random.RandomState(0), [True, False]))
    sym = torch.zeros((1, 8), dtype=torch.int32)
    buf, lens = torch_coder.encode_streams(sym, table)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
    torch_coder.decode_streams(buf, lens, 8, table)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"


# -- the host coder against the goldens, the front end and the JAX package ----
def _port_table(ragged):
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")


def _mixed(rng, overflows, prec_range=(8, 16)):
    cdfs, precs = [], []
    for _ in overflows:
        prec = int(rng.randint(*prec_range))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, 30))))
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    return jax_tables.build_ragged_cdf(cdfs, precs, list(overflows))


def _golden_names():
    with np.load(GOLDEN) as gold:
        return sorted(k[: -len("__cdf")] for k in gold.files
                      if k.endswith("__cdf"))


@pytest.mark.parametrize("name", _golden_names())
def test_golden_bytes(name):
    """Every one-row case of golden.npz: the reference coder's bytes from
    the host coder and from the front end, each decoded by the other."""
    gold = np.load(GOLDEN)
    data = gold[f"{name}__data"].astype(np.int32)[None]
    table = _port_table(jax_tables.build_ragged_cdf(
        [gold[f"{name}__cdf"]], [int(gold[f"{name}__precision"])], [False]))
    ref = gold[f"{name}__bytes"].tobytes()
    assert host.encode_streams(data, table.host) == [ref]
    buf, lens = torch_coder.encode_streams(torch.as_tensor(data), table)
    assert torch_coder.to_bytes_list(buf.numpy(), lens.numpy()) == [ref]
    dec, ok = host.decode_streams([ref], data.shape[1], table.host)
    np.testing.assert_array_equal(dec, data)
    assert ok.all()
    dec, ok = torch_coder.decode_streams(buf, lens, data.shape[1], table)
    np.testing.assert_array_equal(dec.numpy(), data)
    assert bool(ok.all())


# (overflow flags per row, streams, symbols, Laplace scale)
MIXED_CASES = {
    "mixed": ([True, False, True, True, False], 20, 37, 12.0),
    "all_overflow": ([True] * 4, 16, 64, 25.0),
    "wide": ([True, True], 6, 130, 400.0),
    "bounded": ([False] * 3, 9, 50, 2.0),
}
CORRUPTIONS = ["none", "truncated", "bitflip", "random", "empty", "tiny"]


def _mixed_case(name):
    rng = np.random.RandomState(sorted(MIXED_CASES).index(name))
    overflows, s, n, scale = MIXED_CASES[name]
    ragged = _mixed(rng, overflows)
    idx = rng.randint(0, len(overflows), (s, n)).astype(np.int32)
    sym = np.round(rng.laplace(0, scale, (s, n))).astype(np.int32)
    table = jax_tables.parse_ragged_cdf(ragged)
    # Bounded rows take values inside their range only (outside it the
    # reference clips; the route's contract is the reference's).
    top = np.asarray(table.length)[idx] - 2
    bounded = ~np.asarray(table.overflow)[idx]
    sym = np.where(bounded, np.clip(sym, 0, top), sym).astype(np.int32)
    return ragged, sym, idx


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
    elif kind == "tiny":
        buf[:, :3] = 0xFF
        lens = np.minimum(lens, 3)
    # A container holds zeros past each stream's length.
    cols = np.arange(buf.shape[1])[None, :]
    return np.where(cols < lens[:, None], buf, 0).astype(np.uint8), lens


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", sorted(MIXED_CASES))
def test_matches_jax_coder(name, kind):
    """Mixed rows, overflow and bounded, with escapes: the host coder's
    strings equal jax_coder.encode_streams' and the front end's, and its
    decode of the (corrupted) streams gives jax_coder.decode_streams'
    symbols and sanity flags, as the front end's does."""
    ragged, sym, idx = _mixed_case(name)
    jax_table = jax_tables.parse_ragged_cdf(ragged)
    ref_buf, ref_lens = jax_coder.encode_streams(sym, jax_table, idx)
    table = _port_table(ragged)
    strings = host.encode_streams(sym, table.host, idx)
    assert strings == torch_coder.to_bytes_list(ref_buf, ref_lens)
    buf, lens = torch_coder.encode_streams(torch.as_tensor(sym), table,
                                           torch.as_tensor(idx))
    assert torch_coder.to_bytes_list(buf.numpy(), lens.numpy()) == strings
    bad, bad_lens = _corrupt(kind, ref_buf, ref_lens,
                             np.random.RandomState(CORRUPTIONS.index(kind)))
    ref_sym, ref_ok = jax_coder.decode_streams(
        bad, bad_lens, sym.shape[1], jax_table, idx)
    dec, ok = host.decode_streams(torch_coder.to_bytes_list(bad, bad_lens),
                                  sym.shape[1], table.host, idx)
    np.testing.assert_array_equal(dec, np.asarray(ref_sym))
    np.testing.assert_array_equal(ok, np.asarray(ref_ok))
    dec_f, ok_f = torch_coder.decode_streams(
        torch.as_tensor(bad), torch.as_tensor(bad_lens), sym.shape[1], table,
        torch.as_tensor(idx))
    np.testing.assert_array_equal(dec_f.numpy(), dec)
    np.testing.assert_array_equal(ok_f.numpy(), ok)
    if kind == "none":
        np.testing.assert_array_equal(dec, sym)


def test_host_rejects_mismatched_indexes():
    ragged, sym, idx = _mixed_case("mixed")
    table = _port_table(ragged)
    strings = host.encode_streams(sym, table.host, idx)
    with pytest.raises(ValueError, match="index"):
        host.decode_streams(strings, sym.shape[1] - 1, table.host, idx)


# -- the entropy models' classic strings on the host ---------------------------
@pytest.fixture(scope="module")
def ems():
    """bmshj2018's two entropy models at 8 filters and 16 scales, on the
    CPU, and a latent with escapes for each."""
    model = bmshj2018.BMSHJ2018Model(num_filters=8, num_scales=16, seed=1)
    codec = bmshj2018.BMSHJ2018Codec(model, device="cpu")
    x = np.random.RandomState(5).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    with torch.no_grad():
        y, z, indexes, _ = codec._encode(codec._upload(x))
    return codec, 40.0 * y, 30.0 * z, indexes


@pytest.mark.parametrize("model", ["indexed", "batched"])
def test_entropy_model_strings_on_host(ems, model):
    """compress_to_strings equals the host coder's strings of the same
    symbols; the host coder decodes them to em.quantize, as em.decompress
    does; a corrupt string fails the sanity check both ways."""
    codec, y, z, indexes = ems
    with torch.no_grad():
        if model == "indexed":
            em = codec.em
            strings = em.compress_to_strings(y, indexes)
            symbols, idx2, _ = em._symbols(y, indexes)
            expect, shape_arg = em.quantize(y), indexes
        else:
            em = codec.side_em
            strings = em.compress_to_strings(z)
            symbols, _, _ = em._symbols_from_bottleneck(z)
            idx2 = None
            expect, shape_arg = em.quantize(z), tuple(z.shape[1:3])
        assert host.encode_streams(_np(symbols), em.device_table.host,
                                   _np(idx2)) == strings
        dec, ok = host.decode_streams(strings, symbols.shape[1],
                                      em.device_table.host, _np(idx2))
        assert ok.all()
        np.testing.assert_array_equal(dec, symbols.numpy())
        out = em.decompress(strings, shape_arg)
        assert torch.equal(out.reshape(expect.shape), expect)
        bad = [s + b"\x12\x34" for s in strings]
        _, ok = host.decode_streams(bad, symbols.shape[1],
                                    em.device_table.host, _np(idx2))
        assert not ok.any()
        with pytest.raises(ValueError, match="Sanity"):
            em.decompress(bad, shape_arg)


def test_location_scale_with_loc_on_host(monkeypatch):
    """The location-scale model with ``loc``, as ms2020 codes its slices:
    with the host coder in the front end's place, the same strings, decoded
    to round(y - loc) + loc."""
    em = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, 16, bmshj2018.make_scale_fn(0.11, 64, 16),
        coding_rank=3, compression=True, device="cpu")
    rng = np.random.RandomState(9)
    y = torch.as_tensor(rng.normal(0, 20, (1, 6, 5, 4)).astype(np.float32))
    loc = torch.as_tensor(rng.normal(0, 3, y.shape).astype(np.float32))
    sigma = torch.as_tensor(rng.uniform(0, 15, y.shape).astype(np.float32))
    plain = em.compress_to_strings(y, sigma, loc=loc)
    monkeypatch.setattr(torch_coder, "encode_streams", _host_encode)
    monkeypatch.setattr(torch_coder, "decode_streams", _host_decode)
    assert em.compress_to_strings(y, sigma, loc=loc) == plain
    out = em.decompress(plain, sigma, loc=loc)
    assert torch.equal(out, em.quantize(y, loc))


# -- the classic containers with the host coder in the front end's place -------
@pytest.fixture(scope="module")
def codecs():
    return {
        "bls2017": bls2017.BLS2017Codec(
            bls2017.BLS2017Model(num_filters=16, seed=2), device="cpu"),
        "bmshj2018": bmshj2018.BMSHJ2018Codec(
            bmshj2018.BMSHJ2018Model(num_filters=16, seed=2), device="cpu"),
        "ms2020": ms2020.MS2020Codec(ms2020.MS2020Model(
            num_filters=16, latent_depth=20, hyperprior_depth=8,
            num_slices=5, max_support_slices=3, num_scales=16,
            ha_widths=(24, 16), hs_widths=(12, 16, 20),
            slice_widths=(16, 12), seed=2), device="cpu"),
    }


@pytest.mark.parametrize("shape", [(64, 64, 3), (61, 47, 3)])
@pytest.mark.parametrize("model", ["bls2017", "bmshj2018", "ms2020"])
def test_classic_container_on_host(codecs, monkeypatch, model, shape):
    """compress with the front end's plain versions and with the host
    coder in their place: identical containers, which both ways decode to
    reconstruct(x); a corrupt one raises on the host too."""
    codec = codecs[model]
    x = np.random.RandomState(shape[1]).randint(0, 256, shape).astype(
        np.uint8)
    plain = codec.compress(x)
    assert torch_coder.DISPATCH_LOG["encode"].startswith("plain-")
    expect = codec.reconstruct(x)
    np.testing.assert_array_equal(codec.decompress(plain), expect)
    monkeypatch.setattr(torch_coder, "encode_streams", _host_encode)
    monkeypatch.setattr(torch_coder, "decode_streams", _host_decode)
    assert codec.compress(x) == plain
    np.testing.assert_array_equal(codec.decompress(plain), expect)
    np.testing.assert_array_equal(
        codec.decompress_native_many([plain])[0], expect)
    raw = PackedTensors(plain).unpack_raw()
    first = next(i for i, t in enumerate(raw) if isinstance(t, list))
    raw[first] = [s + b"\x12\x34" for s in raw[first]]
    bad = PackedTensors()
    bad.model = codec.MODEL_ID
    bad.pack([t if isinstance(t, list) else t.astype(np.int32)
              for t in raw])
    with pytest.raises(ValueError):
        codec.decompress(bad.string)
