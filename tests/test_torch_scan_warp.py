"""The warp-per-stream micro-op encode (K6's micro-op mode, one warp per
stream) on the CPU: the plain mirror of its kernel,
``cuda_coder.encode_scan_warp_plain`` (the 32-bit chain, the ballot and
search that hand each lane its coded step, chunks held one a lane and
stored 64 bytes at a time, fill runs through the same window), against the
JAX package's ``jax_coder.encode_core`` and the reference coder's golden
bytes; and the wrappers' choice of kernel on the CPU.

Every comparison is exact: the coder has no tolerance.  ``encode_core``
runs its XLA scan on the CPU, as the JAX package's own tests run it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import jax_coder
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
from scan_cases import as_tensors, limit_micro_ops, long_carry_ops
from scan_cases import valid_micro_ops as _valid_ops

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def _jax_encode(lower, upper, prec, mask, out_size):
    buf, lens = jax_coder.encode_core(
        jnp.asarray(lower, jnp.uint32), jnp.asarray(upper, jnp.uint32),
        jnp.asarray(prec, jnp.uint32), jnp.asarray(mask), out_size)
    return np.asarray(buf), np.asarray(lens)


def _mirror(lower, upper, prec, mask, out_size):
    args = as_tensors((lower, upper, prec, mask))
    out = torch.full((lower.shape[1], out_size), 0xAB, dtype=torch.uint8)
    lens = torch.full((lower.shape[1],), -1, dtype=torch.int32)
    cuda_coder.encode_scan_warp_plain(*args, out, lens)
    return out.numpy(), lens.numpy()


def _assert_mirror_matches_jax(lower, upper, prec, mask, out_size=None):
    out_size = 2 * lower.shape[0] + 2 if out_size is None else out_size
    buf, lens = _mirror(lower, upper, prec, mask, out_size)
    ref_buf, ref_lens = _jax_encode(lower, upper, prec, mask, out_size)
    np.testing.assert_array_equal(lens, ref_lens)
    np.testing.assert_array_equal(buf, ref_buf)
    return buf, lens


# -- the 32-bit step against the JAX package's u64-exact step ---------------
# (base, size - 1, lower, upper, precision)
EDGE_STATES = {
    "start_size_2p32": (0, M32, 3, 9, 4),
    "start_full_interval_p16": (0, M32, 0, 1 << 16, 16),
    "full_interval_p1": (0x12345678, 0x7FFFFFFF, 0, 2, 1),
    "lower_zero_p16": (0x00010000, 0xFFFEFFFF, 0, 1, 16),
    "upper_top_p16": (0x00010000, 0xFFFEFFFF, 65535, 65536, 16),
    "upper_top_p1": (0x80000000, 0x7FFFFFFF, 1, 2, 1),
    "bit_zero_p1": (0x0000FFFF, 0x0001FFFF, 0, 1, 1),
    "sm1_2p16_minus_1": (0x40000000, 0xFFFF, 1, 2, 2),
    "sm1_2p16": (0x40000000, 0x10000, 7, 8, 3),
    "sm1_2p16_p16": (0x40000000, 0x10000, 65535, 65536, 16),
    "base_near_2p32": (0xFFFFFFF0, 0xF, 0, 1, 1),
    "base_near_2p32_up": (0xFFFF0000, 0xFFFF0000, 12345, 23456, 16),
    "carry_out": (0xFFFFFF00, 0xFFFFFFFF, 40000, 65536, 16),
    "straddle_renorm": (0xFFFFF000, 0xFFFFFF, 0x7FFF, 0x8001, 16),
}


@pytest.mark.parametrize("name", sorted(EDGE_STATES))
def test_chain32_matches_jax_step(name):
    """``cuda_coder.scan_chain32`` on the packed operands (the kernel's
    32-bit chain) against jax_coder._encode_step (the reference's exact
    48-bit products): the state after the step, the carry out of 2^32 and
    whether the interval still straddles 2^32; and against the u64
    arithmetic of the port's plain recurrence."""
    base, sm1, lower, upper, prec = EDGE_STATES[name]
    nb, ns, up, straddle, renorm, sb, ss = cuda_coder.scan_chain32(
        base, sm1, cuda_coder.scan_op(lower, upper, prec))
    carry = (jnp.asarray([base], jnp.uint32), jnp.asarray([sm1], jnp.uint32),
             jnp.asarray([1], jnp.uint32), jnp.zeros(1, jnp.int32),
             jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    op = (jnp.asarray([lower], jnp.uint32), jnp.asarray([upper], jnp.uint32),
          jnp.asarray([prec], jnp.uint32), jnp.asarray([True]))
    (j_base, j_sm1, *_), rec = jax_coder._encode_step(carry, op)
    rec = int(rec[0])
    assert (sb, ss) == (int(j_base[0]), int(j_sm1[0]))
    assert up == bool((rec >> 20) & 1)
    assert straddle == (not (rec >> 19) & 1)
    # The plain recurrence's u64 form (cuda_coder._encode_plain).
    size = sm1 + 1
    a = (size * lower) >> prec
    b = ((size * upper) >> prec) - 1
    assert nb == (base + a) & M32 and ns == (b - a) & M32
    assert up == (nb < a) and renorm == ((ns >> 16) == 0)
    assert straddle == (nb + ns > M32)


# -- the reference coder's golden bytes --------------------------------------
def _golden_names():
    gold = np.load(GOLDEN)
    return sorted({k.rsplit("__", 1)[0] for k in gold.files
                   if k.endswith("__cdf")})


@pytest.mark.parametrize("name", _golden_names())
def test_golden_cases_as_micro_ops(name):
    """Every single-row case of golden.npz (carry_p16, short_*, dirac_*,
    uniform_*, zipf_*) turned into micro-ops: the mirror writes the
    reference coder's bytes, in a row of odd width too."""
    gold = np.load(GOLDEN)
    prec = int(gold[f"{name}__precision"])
    host = tables.parse_ragged_cdf(tables.build_ragged_cdf(
        [gold[f"{name}__cdf"]], [prec], [False]))
    table = torch_coder.DeviceCdfTable(host, "cpu")
    cdf, meta = table.indexed_arrays()
    sym = torch.as_tensor(gold[f"{name}__data"].astype(np.int32)[None])
    ops = [t.numpy() for t in cuda_coder.gamma_micro_ops(
        sym, torch.zeros_like(sym), cdf, meta, sym.shape[1], 1)]
    ref = gold[f"{name}__bytes"].tobytes()
    for out_size in (2 * sym.shape[1] + 2, 2 * sym.shape[1] + 7):
        buf, lens = _mirror(*ops, out_size)
        assert int(lens[0]) == len(ref)
        assert buf[0, : len(ref)].tobytes() == ref
        assert not buf[0, len(ref):].any()


# -- random micro-ops with holes ---------------------------------------------
# (steps, streams, share of coded steps, precisions)
RANDOM_CASES = {
    "dense_one_stream": (700, 1, 1.0, (1, 17)),
    "holes_one_stream": (700, 1, 0.7, (1, 17)),
    "sparse_holes": (300, 2, 0.1, (1, 17)),
    "precision_16": (500, 3, 0.9, (16, 17)),
    "precision_1": (400, 2, 0.8, (1, 2)),
    "low_precisions": (400, 3, 0.95, (1, 5)),
    "many_streams": (90, 9, 0.6, (8, 17)),
    "padding_tail": (257, 2, 1.0, (1, 17)),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_micro_ops_match_jax(name):
    """Seeded valid micro-ops, masked steps anywhere (holding padding or
    noise): bytes and lengths equal encode_core's and the port's plain
    recurrence's."""
    steps, streams, coded, precs = RANDOM_CASES[name]
    rng = np.random.RandomState(20 + sorted(RANDOM_CASES).index(name))
    lower, upper, prec, mask = _valid_ops(rng, steps, streams, coded, precs)
    if name == "padding_tail":
        mask[200:] = False
        lower[200:], upper[200:], prec[200:] = 0, 1, 1
    buf, lens = _assert_mirror_matches_jax(lower, upper, prec, mask)
    args = as_tensors((lower, upper, prec, mask))
    plain = cuda_coder.encode_scan(*args, buf.shape[1])
    np.testing.assert_array_equal(buf, plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())


@pytest.mark.parametrize("streams", [1, 3])
def test_interval_limits_match_jax(streams):
    """Every coded step at a limit of the valid range (the whole range,
    its first or its last entry, at precision 1, 2, 15 and 16), from the
    start state size = 2^32 on: bytes equal encode_core's."""
    rng = np.random.RandomState(40 + streams)
    _assert_mirror_matches_jax(*limit_micro_ops(rng, 300, streams))


# -- delayed-carry groups with a fill run longer than a window --------------
@pytest.mark.parametrize("fill_chunks", [3, 33, 70])
@pytest.mark.parametrize("direction", ["up", "down"])
def test_long_delayed_carry_matches_jax(direction, fill_chunks):
    """A delayed-carry group whose fill run is longer than a window of 32
    chunks (and one shorter), flushed in each direction: bytes equal
    encode_core's, and the fill bytes are 0x00 up and 0xFF down."""
    ops, run = long_carry_ops(direction, fill_chunks,
                              fill_chunks + (direction == "up"))
    assert run >= fill_chunks
    buf, lens = _assert_mirror_matches_jax(*ops)
    fill = b"\x00\x00" if direction == "up" else b"\xff\xff"
    assert fill * fill_chunks in buf[0, : int(lens[0])].tobytes()


# -- shapes: empty, all masked, window boundaries ----------------------------
@pytest.mark.parametrize("coded", [0, 1, 31, 32, 33, 63, 64, 65, 96])
def test_window_boundaries_match_jax(coded):
    """Streams of ``coded`` coded steps, ending on a window of 32 chunks
    or one step either side of it, among masked steps; and T = 0."""
    rng = np.random.RandomState(100 + coded)
    steps = coded + 40
    lower, upper, prec, mask = _valid_ops(rng, steps, 3)
    mask[:] = False
    for s in range(3):
        mask[np.sort(rng.choice(steps, coded, replace=False)), s] = True
    _assert_mirror_matches_jax(lower, upper, prec, mask)
    if coded == 0:
        empty = [np.zeros((0, 2), np.int64)] * 3 + [np.zeros((0, 2), bool)]
        buf, lens = _mirror(*empty, 2)
        assert buf.shape == (2, 2) and not buf.any() and not lens.any()


def test_all_masked_stream_is_empty():
    rng = np.random.RandomState(7)
    lower, upper, prec, mask = _valid_ops(rng, 70, 2)
    mask[:, 1] = False
    buf, lens = _assert_mirror_matches_jax(lower, upper, prec, mask, 147)
    assert int(lens[1]) == 0 and not buf[1].any()


def test_nth_set_bit_search():
    """The kernel's search hands lane i the i-th set bit of the ballot."""
    rng = np.random.RandomState(8)
    for bits in [0xFFFFFFFF, 1, 1 << 31, 0x80000001] + list(
            rng.randint(0, 1 << 32, 40, dtype=np.int64)):
        bits = int(bits)
        where = [b for b in range(32) if bits >> b & 1]
        for i, pos in enumerate(where):
            assert cuda_coder._nth_set_bit(bits, i) == pos


# -- the wrappers on the CPU -------------------------------------------------
@pytest.mark.parametrize("variant", ["encode_scan", "encode_scan_warp",
                                     "encode_scan_thread"])
def test_cpu_wrappers_run_the_plain_version(variant):
    """On CPU tensors every wrapper runs encode_scan_plain and launches
    nothing; the warp kernel's mirror gives the same bytes."""
    rng = np.random.RandomState(9)
    args = as_tensors(_valid_ops(rng, 100, 3, 0.8))
    before = dict(cuda_coder.LAUNCHES), dict(cuda_coder.LAUNCHES_WARP)
    buf, lens = getattr(cuda_coder, variant)(*args, 203)
    assert (dict(cuda_coder.LAUNCHES), dict(cuda_coder.LAUNCHES_WARP)) == \
        before
    ref = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_scan_plain(*args, *ref)
    assert torch.equal(buf, ref[0]) and torch.equal(lens, ref[1])
    mirror = torch.empty_like(buf), torch.empty_like(lens)
    cuda_coder.encode_scan_warp_plain(*args, *mirror)
    assert torch.equal(buf, mirror[0]) and torch.equal(lens, mirror[1])
    with pytest.raises(ValueError):
        getattr(cuda_coder, variant)(*args, 201)


def test_dispatch_constant():
    assert isinstance(cuda_coder.WARP_ENCODE_MAX_STREAMS, int)
    assert cuda_coder.WARP_ENCODE_MAX_STREAMS >= 1
    assert set(cuda_coder.LAUNCHES_WARP) == {
        "decode_indexed", "decode_gamma", "encode_scan", "encode_gamma",
        "encode_indexed"}
