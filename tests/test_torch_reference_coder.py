"""The port's reference-format (.tfci) coder against the JAX package: plain
versions of the single-row kernels (K4', K5') and of the in-stream-gamma
kernels (K6', K3') through compression_tpu_torch.codec.torch_coder's
encode_streams / decode_streams, and the batched entropy model's
reference-format compress / decompress.

Every comparison is exact (bytes, lengths, padded widths, symbols, sanity
flags): the coder has no tolerance.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from compression_tpu.codec import jax_coder, pallas_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JEM
from compression_tpu import distributions as jax_dist
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
GOLDEN_EM = os.path.join(os.path.dirname(__file__), "golden",
                         "golden_em.npz")
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _zipf_row(alphabet, precision, alpha=1.2):
    pmf = 1.0 / (1 + np.arange(alphabet)) ** alpha
    pmf /= pmf.sum()
    return pmf, jax_tables.build_ragged_cdf(
        [jax_tables.pmf_to_quantized_cdf(pmf, precision)], [precision],
        [False])


def _mixed_ragged(rng, overflows, prec_range=(8, 16)):
    cdfs, precs = [], []
    for _ in overflows:
        prec = int(rng.randint(*prec_range))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, 30))))
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    return jax_tables.build_ragged_cdf(cdfs, precs, list(overflows))


def _port_table(ragged):
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")


def _jax_table(ragged):
    return jax_tables.parse_ragged_cdf(ragged)


def _encode_both(ragged, sym, idx=None):
    """(JAX buf, lengths), (port buf, lengths) of encode_streams."""
    ref = jax_coder.encode_streams(sym, _jax_table(ragged), idx)
    mine = torch_coder.encode_streams(
        torch.as_tensor(sym), _port_table(ragged),
        None if idx is None else torch.as_tensor(idx))
    return ref, tuple(t.numpy() for t in mine)


def _decode_core(ragged, buf, lens, idx, gamma):
    """jax_coder.decode_core, the oracle the TPU decoders are held to."""
    dt = jax_coder.DeviceCdfTable(_jax_table(ragged))
    sym, ok = jax_coder.decode_core(
        jnp.asarray(jax_coder.bytes_to_chunks(buf, lens)), jnp.asarray(lens),
        jnp.asarray(idx), idx.shape[1], dt.cdf, dt.length, dt.precision,
        dt.overflow, None, gamma)
    return np.asarray(sym), np.asarray(ok)


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


CORRUPTIONS = ["none", "truncated", "bitflip", "random", "empty", "tiny"]


# -- K4' / K5': one shared row, no overflow ---------------------------------
@pytest.mark.parametrize("precision,alphabet", [(12, 256), (8, 40), (16, 40),
                                                (15, 3)])
def test_single_row_encode_matches_jax(precision, alphabet):
    """K4' plain == encode_streams (out-of-range values clipped), and the
    route is the single-row one in channel and indexed mode alike."""
    rng = np.random.RandomState(precision)
    pmf, ragged = _zipf_row(alphabet, precision)
    sym = rng.choice(alphabet, size=(24, 77), p=pmf).astype(np.int32)
    sym[0, :4] = [-5, alphabet + 3, INT32_MIN, INT32_MAX]
    for idx in (None, np.zeros_like(sym)):
        (buf, lens), (mine, mine_lens) = _encode_both(ragged, sym, idx)
        assert torch_coder.DISPATCH_LOG["encode"] == "plain-single"
        np.testing.assert_array_equal(mine, buf)
        np.testing.assert_array_equal(mine_lens, lens)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_coder.pl, "pallas_call", patched)


def test_single_row_encode_matches_pallas_kernel(interpret_pallas):
    """K4' plain == the TPU kernel encode_single_row_device (interpret
    mode), clipping included."""
    rng = np.random.RandomState(5)
    pmf, ragged = _zipf_row(40, 11, 1.3)
    sym = rng.choice(40, size=(128, 24), p=pmf).astype(np.int32)
    sym[:3, 0] = [-1, 40, INT32_MAX]
    table = _port_table(ragged)
    cdf, meta = table.indexed_arrays()
    out_size = torch_coder.stream_out_size(24)
    mine, mine_lens = cuda_coder.encode_single_row(
        torch.as_tensor(sym), cdf, meta, out_size)
    jt = _jax_table(ragged)
    buf, lens = pallas_coder.encode_single_row_device(
        jnp.asarray(sym), np.asarray(jt.cdf[0][: int(jt.length[0])]), 11,
        out_size, sub=1)
    np.testing.assert_array_equal(mine_lens.numpy(), np.asarray(lens))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(buf))


@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_single_row_decode_matches_decode_core(kind, precision):
    """K5' plain == decode_core's single-row (bucketed) search: symbols and
    sanity flags, on intact and corrupt streams."""
    rng = np.random.RandomState(precision + CORRUPTIONS.index(kind))
    pmf, ragged = _zipf_row(40, precision)
    sym = rng.choice(40, size=(32, 45), p=pmf).astype(np.int32)
    buf, lens = jax_coder.encode_streams(sym, _jax_table(ragged))
    buf, lens = _corrupt(kind, buf, lens, rng)
    ref, ref_ok = _decode_core(ragged, buf, lens, np.zeros_like(sym), False)
    mine, ok = torch_coder.decode_streams(
        torch.as_tensor(buf), torch.as_tensor(lens), 45, _port_table(ragged))
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-single"
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    if kind == "none":
        np.testing.assert_array_equal(mine.numpy(), sym)
        assert ok.all()


# golden.npz cases for K4' / K5' on the CPU: the short streams, the carry
# case and one of each distribution, precisions 1 to 16 (each long case
# costs ~2 s of plain single-stream steps here; chip_smoke.py runs every
# case through the kernels, and test_torch_coder.py every case through the
# plain recurrence the two kernels share with K1).
GOLDEN_SUBSET = ["carry_p16", "dirac_p8", "short_0", "short_1", "short_17",
                 "short_2", "short_3", "short_5", "uniform_p12", "zipf_p1",
                 "zipf_p16"]


@pytest.mark.parametrize("name", GOLDEN_SUBSET)
def test_single_row_golden_bytes(name):
    """golden.npz cases, coded on their own one-row table through K4' and
    decoded through K5': the reference C++ coder's bytes."""
    gold = np.load(GOLDEN)
    data = gold[f"{name}__data"].astype(np.int32)[None]
    table = _port_table(jax_tables.build_ragged_cdf(
        [gold[f"{name}__cdf"]], [int(gold[f"{name}__precision"])], [False]))
    buf, lens = torch_coder.encode_streams(torch.as_tensor(data), table)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-single"
    assert buf[0, : int(lens[0])].numpy().tobytes() == \
        gold[f"{name}__bytes"].tobytes()
    dec, ok = torch_coder.decode_streams(buf, lens, data.shape[1], table)
    np.testing.assert_array_equal(dec.numpy(), data)
    assert bool(ok.all())


# -- K6' / K3': in-stream Elias-gamma escapes -------------------------------
def _escape_case(name):
    """(ragged, symbols, indexes): mixed rows, overflow and bounded, with
    escapes of every size."""
    rng = np.random.RandomState(sorted(ESCAPE_CASES).index(name))
    overflows, s, n, scale = ESCAPE_CASES[name]
    ragged = _mixed_ragged(rng, overflows)
    idx = rng.randint(0, len(overflows), (s, n)).astype(np.int32)
    sym = np.round(rng.laplace(0, scale, (s, n))).astype(np.int32)
    if name == "extremes":
        # Magnitudes >= 2^20, negatives and the INT32 extremes, on the
        # overflow row 0.
        vals = [INT32_MIN, INT32_MAX, -(2 ** 20), 2 ** 20 + 3, 2 ** 30,
                -(2 ** 31 - 1), INT32_MAX - 1, -1]
        sym[: len(vals), 2] = vals
        idx[: len(vals), 2] = 0
    return ragged, sym, idx


# (overflow flags per row, streams, symbols, Laplace scale)
ESCAPE_CASES = {
    "mixed": ([True, False, True, True, False], 20, 37, 12.0),
    "all_overflow": ([True] * 4, 16, 64, 25.0),
    "wide": ([True, True], 6, 130, 400.0),
    "extremes": ([True, False, True], 12, 9, 3.0),
}


@pytest.mark.parametrize("name", sorted(ESCAPE_CASES))
def test_gamma_encode_matches_jax(name):
    """K6' plain == jax_coder.encode_streams on data with escapes: the
    padded arrays (widths included) and the lengths; on the extremes its
    micro-ops equal micro_ops_from_symbols'."""
    ragged, sym, idx = _escape_case(name)
    (buf, lens), (mine, mine_lens) = _encode_both(ragged, sym, idx)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"
    assert mine.shape == buf.shape
    np.testing.assert_array_equal(mine, buf)
    np.testing.assert_array_equal(mine_lens, lens)
    if name != "extremes":
        return
    table = _port_table(ragged)
    cdf, meta = table.indexed_arrays()
    counts, _, _, _ = cuda_coder.interval_counts(
        torch.as_tensor(sym), torch.as_tensor(idx), meta)
    num_steps = (buf.shape[1] - 4) // 2  # out_size = 2 * num_steps + 4
    ops = cuda_coder.gamma_micro_ops(torch.as_tensor(sym),
                                     torch.as_tensor(idx), cdf, meta,
                                     num_steps)
    ref = jax_coder.micro_ops_from_symbols(
        jnp.asarray(sym), jnp.asarray(idx),
        jax_coder.DeviceCdfTable(_jax_table(ragged)), int(counts.max()),
        num_steps)
    for a, b in zip(ops, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            np.int64))


def test_gamma_encode_matches_pallas_scan(interpret_pallas):
    """K6' plain == encode_scan_pallas (interpret mode) over the JAX
    micro-ops, resolved to bytes by jax_coder._encode_postpass."""
    ragged, sym, idx = _escape_case("mixed")
    sym, idx = np.tile(sym[:16, :8], (16, 1)), np.tile(idx[:16, :8], (16, 1))
    jt = jax_coder.DeviceCdfTable(_jax_table(ragged))
    table = _port_table(ragged)
    cdf, meta = table.indexed_arrays()
    counts, _, _, _ = cuda_coder.interval_counts(
        torch.as_tensor(sym), torch.as_tensor(idx), meta)
    num_steps = -(-int(counts.sum(1).max()) // 64) * 64
    out_size = torch_coder.stream_out_size(int(counts.sum(1).max()))
    ops = jax_coder.micro_ops_from_symbols(
        jnp.asarray(sym), jnp.asarray(idx), jt, int(counts.max()), num_steps)
    rec, state = pallas_coder.encode_scan_pallas(*ops)
    buf, lens = jax_coder._encode_postpass(rec, state, out_size)
    mine, mine_lens = cuda_coder.encode_gamma(
        torch.as_tensor(sym), torch.as_tensor(idx), cdf, meta, out_size)
    np.testing.assert_array_equal(mine_lens.numpy(), np.asarray(lens))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(buf))


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", ["mixed", "extremes"])
def test_gamma_decode_matches_decode_core(name, kind):
    """K3' plain == decode_core with in-stream gamma: symbols and sanity
    flags, on intact and corrupt streams."""
    ragged, sym, idx = _escape_case(name)
    rng = np.random.RandomState(CORRUPTIONS.index(kind))
    buf, lens = jax_coder.encode_streams(sym, _jax_table(ragged), idx)
    buf, lens = _corrupt(kind, buf, lens, rng)
    ref, ref_ok = _decode_core(ragged, buf, lens, idx, True)
    mine, ok = torch_coder.decode_streams(
        torch.as_tensor(buf), torch.as_tensor(lens), sym.shape[1],
        _port_table(ragged), torch.as_tensor(idx))
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    if kind == "none" and name == "mixed":
        # Bounded rows clip, overflow rows give the values back.
        jt = _jax_table(ragged)
        ovf = np.asarray(jt.overflow)[idx]
        np.testing.assert_array_equal(mine.numpy()[ovf], sym[ovf])
        assert ok.all()


@pytest.mark.parametrize("fill", [0x00, 0xFF, 0x5A])
def test_gamma_decode_unary_bound(fill):
    """A row holding only the escape marker makes every symbol an escape;
    on zero bytes every gamma bit reads 0, so only the n < 31 bound ends
    the unary count.  Symbols and flags equal decode_core's."""
    ragged = jax_tables.build_ragged_cdf(
        [np.asarray([0, 4096], np.int32),
         jax_tables.pmf_to_quantized_cdf(np.full(5, 0.2), 12)],
        [12, 12], [True, True])
    idx = np.zeros((4, 6), np.int32)
    idx[2:, ::2] = 1
    buf = np.full((4, 40), fill, np.uint8)
    lens = np.asarray([40, 8, 3, 0], np.int32)
    cols = np.arange(40)[None, :]
    buf = np.where(cols < lens[:, None], buf, 0).astype(np.uint8)
    ref, ref_ok = _decode_core(ragged, buf, lens, idx, True)
    mine, ok = torch_coder.decode_streams(
        torch.as_tensor(buf), torch.as_tensor(lens), 6, _port_table(ragged),
        torch.as_tensor(idx))
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    if fill == 0:
        assert mine.numpy()[0, 0] == INT32_MAX  # 31 zeros, 31 zero bits


@pytest.mark.parametrize("channel", [True, False])
def test_routes_match_jax(channel):
    """Escape-free data: K1 and K2 serve the reference format on other
    tables (bytes and symbols equal JAX's); overflow tables decode through
    K3'."""
    rng = np.random.RandomState(9)
    for overflow in (False, True):
        ragged = _mixed_ragged(rng, [overflow] * 4, (10, 14))
        jt = _jax_table(ragged)
        idx = np.broadcast_to(np.arange(30, dtype=np.int32) % 4, (7, 30)) \
            if channel else rng.randint(0, 4, (7, 30)).astype(np.int32)
        sym = np.minimum(rng.randint(0, 4, (7, 30)),
                         jt.length[idx] - 3).astype(np.int32)
        use = None if channel else idx
        (buf, lens), (mine, mine_lens) = _encode_both(ragged, sym, use)
        assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
        np.testing.assert_array_equal(mine, buf)
        np.testing.assert_array_equal(mine_lens, lens)
        ref, ref_ok = jax_coder.decode_streams(buf, lens, 30, jt, use)
        dec, ok = torch_coder.decode_streams(
            torch.as_tensor(mine), torch.as_tensor(mine_lens), 30,
            _port_table(ragged), None if use is None else torch.as_tensor(use))
        assert torch_coder.DISPATCH_LOG["decode"] == (
            "plain-gamma" if overflow else "plain-indexed")
        np.testing.assert_array_equal(dec.numpy(), ref)
        np.testing.assert_array_equal(ok.numpy(), ref_ok)
        np.testing.assert_array_equal(dec.numpy(), sym)


def test_decode_dispatch_in_stream_gamma():
    """decode_dispatch(in_stream_gamma=True) runs K3' (the sidecar call
    keeps K2)."""
    ragged, sym, idx = _escape_case("all_overflow")
    buf, lens = jax_coder.encode_streams(sym, _jax_table(ragged), idx)
    table = _port_table(ragged)
    args = (torch.tensor(buf), torch.tensor(lens), sym.shape[1], table,
            torch.tensor(idx))
    mine, ok = torch_coder.decode_dispatch(*args, in_stream_gamma=True)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(mine.numpy(), sym)
    assert bool(ok.all())
    sidecar, _ = torch_coder.decode_dispatch(*args)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"
    assert not np.array_equal(sidecar.numpy(), sym)


# -- the batched entropy model's reference format ---------------------------
def _golden_em():
    gold = dict(np.load(GOLDEN_EM))
    params = {
        "matrices": [gold[f"dfb__matrix_{i}"] for i in range(3)],
        "biases": [gold[f"dfb__bias_{i}"] for i in range(3)],
        "factors": [gold[f"dfb__factor_{i}"] for i in range(2)],
    }
    prior = deep_factorized.NoisyDeepFactorized(
        params={k: [torch.tensor(v) for v in vs] for k, vs in params.items()},
        batch_shape=(4,))
    return gold, params, ContinuousBatchedEntropyModel(
        prior=prior, coding_rank=3, compression=True, device="cpu")


def test_em_compress_golden_bytes():
    """golden_em.npz (the TF reference): compress gives its strings
    byte for byte, and decompress of those strings its x_hat."""
    gold, _, em = _golden_em()
    strings = em.compress_to_strings(torch.as_tensor(gold["dfb__x"]))
    ref, off = [], 0
    for n in gold["dfb__nbytes"]:
        ref.append(gold["dfb__bytes"][off: off + int(n)].tobytes())
        off += int(n)
    assert strings == ref
    # x_hat is the decoded integers plus the quantization offset: exact
    # against this model's quantize; against TF's x_hat within 1e-5, the
    # distance of the two estimated offsets (test_golden_em_tables).
    expect = em.quantize(torch.as_tensor(gold["dfb__x"])).numpy()
    x_hat = em.decompress(ref, (8, 8))
    np.testing.assert_array_equal(x_hat.numpy(), expect)
    np.testing.assert_allclose(x_hat.numpy(), gold["dfb__xhat"], rtol=0,
                               atol=1e-5)
    buf, lens = em.compress(torch.as_tensor(gold["dfb__x"]))
    np.testing.assert_array_equal(em.decompress(buf, (8, 8), lens).numpy(),
                                  expect)


@pytest.fixture(scope="module")
def em_pair():
    """(JAX EM, port EM) on golden_em.npz's prior; the port's is given the
    JAX model's offset, since the two estimates differ in the last ulp,
    which can round a latent differently."""
    _, params, own = _golden_em()
    jp = jax_dist.NoisyDeepFactorized(
        params={k: [jnp.asarray(v) for v in vs] for k, vs in params.items()},
        batch_shape=(4,))
    jem = JEM(prior=jp, coding_rank=3, compression=True)
    return jem, ContinuousBatchedEntropyModel(
        prior=own.prior, coding_rank=3, compression=True, device="cpu",
        quantization_offset=np.asarray(jem.quantization_offset))


@pytest.mark.parametrize("scale", [2.5, 60.0])
def test_em_compress_matches_jax(em_pair, scale):
    """Same latent and tables: the port's compress equals the JAX EM's
    (padded buffer and lengths), and each package decodes the other's
    streams to the quantized latent (scale 60 escapes on both sides)."""
    jem, em = em_pair
    y = np.random.RandomState(int(scale)).normal(
        0, scale, (3, 2, 5, 4)).astype(np.float32)
    buf, lens = jem.compress(jnp.asarray(y))
    mine, mine_lens = em.compress(torch.as_tensor(y))
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    expect = em.quantize(torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(
        em.decompress(buf, (2, 5), lens).numpy(), expect)
    np.testing.assert_array_equal(
        np.asarray(jem.decompress(mine.numpy(), (2, 5), mine_lens.numpy())),
        expect)
    if scale > 10:
        assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"


def test_em_decompress_sanity_check_raises():
    gold, _, em = _golden_em()
    strings = em.compress_to_strings(torch.as_tensor(gold["dfb__x"]))
    with pytest.raises(ValueError, match="Sanity"):
        em.decompress([s + b"\x12\x34" for s in strings], (8, 8))
    em.decode_sanity_check = False
    em.decompress([s + b"\x12\x34" for s in strings], (8, 8))


def test_em_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid here")
    _, params, _ = _golden_em()
    prior = deep_factorized.NoisyDeepFactorized(
        params={k: [torch.tensor(v) for v in vs] for k, vs in params.items()},
        batch_shape=(4,))
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchedEntropyModel(prior=prior, coding_rank=3,
                                      compression=True)
