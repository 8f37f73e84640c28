"""The port's range coder (plain versions of the CUDA kernels, through
compression_tpu_torch.codec.torch_coder) against the JAX package.

Encode (K1): bytes and lengths identical to jax_coder.encode_streams_sidecar
and to the Pallas kernel pallas_coder.encode_indexed_device run in
interpret mode, and to the reference C++ coder's bytes in golden.npz.
Decode (K2): symbols and sanity flags identical to
jax_coder.decode_streams_sidecar (the XLA scan the TPU kernel is held to),
including on truncated, bit-flipped, random and empty streams.
"""

import os
import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from compression_tpu.codec import jax_coder, pallas_coder
from compression_tpu.codec import tables as jax_tables
from compression_tpu_torch.codec import cuda_coder, tables, torch_coder

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
NO_ESC = (np.zeros((0, 2), np.int32), np.zeros(0, np.int32))


def _mixed_ragged(rng, num_rows, overflow, prec_range):
    cdfs, precs = [], []
    for _ in range(num_rows):
        prec = int(rng.randint(*prec_range))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, 30))))
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    return jax_tables.build_ragged_cdf(cdfs, precs, [overflow] * num_rows)


def _port_table(ragged):
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")


def _port_encode(sym, idx, table):
    out_size = torch_coder.stream_out_size(sym.shape[1])
    buf, lens = torch_coder.encode_dispatch(
        torch.as_tensor(sym), table, out_size, torch.as_tensor(idx))
    return buf.numpy(), lens.numpy()


def _port_decode(buf, lens, idx, table, esc_pos=NO_ESC[0], esc_val=NO_ESC[1]):
    num_streams, n = idx.shape
    sym, sanity = torch_coder.decode_dispatch(
        torch.tensor(buf), torch.tensor(lens),
        n, table, torch.as_tensor(idx))
    flat = torch_coder.sidecar_flatten(esc_pos, num_streams, n)
    sym = torch_coder.sidecar_apply(sym, torch.as_tensor(flat),
                                    torch.as_tensor(esc_val))
    return sym.numpy(), sanity.numpy()


# (prec_range, overflow, streams, symbols): mixed rows at precision 8-16,
# overflow rows with out-of-range values, N not a multiple of 64.
CASES = {
    "bounded_p8-12": ((8, 13), False, 40, 20),
    "bounded_p8-16": ((8, 17), False, 33, 70),
    "bounded_clip": ((10, 15), False, 16, 64),
    "overflow_p12": ((12, 13), True, 24, 64),
    "overflow_p8-15": ((8, 16), True, 37, 101),
    "single_symbol": ((15, 17), False, 5, 1),
}


def _case(name):
    prec_range, overflow, s, n = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    ragged = _mixed_ragged(rng, 6, overflow, prec_range)
    jt = jax_tables.parse_ragged_cdf(ragged)
    idx = rng.randint(0, 6, (s, n)).astype(np.int32)
    sym = rng.randint(-4, 35, (s, n)).astype(np.int32)
    if name != "bounded_clip" and not overflow:
        sym = np.clip(sym, 0, jt.length[idx] - 2).astype(np.int32)
    return ragged, jt, sym, idx


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_matches_jax(name):
    ragged, jt, sym, idx = _case(name)
    buf, lens, _, _ = jax_coder.encode_streams_sidecar(sym, jt, idx)
    mine, mine_lens = _port_encode(sym, idx, _port_table(ragged))
    np.testing.assert_array_equal(mine_lens, lens)
    np.testing.assert_array_equal(mine, buf)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax(name):
    ragged, jt, sym, idx = _case(name)
    buf, lens, esc_pos, esc_val = jax_coder.encode_streams_sidecar(
        sym, jt, idx)
    ref, ref_ok = jax_coder.decode_streams_sidecar(
        buf, lens, sym.shape[1], jt, esc_pos, esc_val, idx)
    mine, ok = _port_decode(buf, lens, idx, _port_table(ragged), esc_pos,
                            esc_val)
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok.all()
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_coder.pl, "pallas_call", patched)


def test_encode_matches_pallas_kernel(interpret_pallas):
    """K1's plain version == the TPU kernel (interpret mode), sidecar
    escapes included."""
    rng = np.random.RandomState(12)
    ragged = _mixed_ragged(rng, 3, True, (8, 16))
    jt = jax_tables.parse_ragged_cdf(ragged)
    idx = rng.randint(0, 3, (128, 16)).astype(np.int32)
    sym = rng.randint(-4, 40, (128, 16)).astype(np.int32)
    mine, mine_lens = _port_encode(sym, idx, _port_table(ragged))
    buf, lens = pallas_coder.encode_indexed_device(
        jnp.asarray(sym), jnp.asarray(idx), jax_coder.DeviceCdfTable(jt),
        mine.shape[1], sub=1)
    np.testing.assert_array_equal(mine_lens, np.asarray(lens))
    np.testing.assert_array_equal(mine, np.asarray(buf))


# -- golden.npz: reference C++ coder bytes --------------------------------
def _golden_names():
    data = np.load(GOLDEN)
    return sorted({k.rsplit("__", 1)[0] for k in data.files
                   if k.endswith("__cdf")})


@pytest.fixture(scope="module")
def golden_runs():
    """Every golden case coded by the port, batched by length: one stream
    per case, each on its own CDF row of a shared table.  JAX codes the
    long groups too (3000 and 5000 symbols, 16 of the cases); for the
    short ones its equality with the reference bytes is tested by the
    JAX package's own golden tests, and compiling its scan once per
    length would dominate this file's run time."""
    gold = np.load(GOLDEN)
    groups = {}
    for name in _golden_names():
        groups.setdefault(len(gold[f"{name}__data"]), []).append(name)
    out = {}
    for n, names in groups.items():
        ragged = jax_tables.build_ragged_cdf(
            [gold[f"{nm}__cdf"] for nm in names],
            [int(gold[f"{nm}__precision"]) for nm in names],
            [False] * len(names))
        jt = jax_tables.parse_ragged_cdf(ragged)
        table = _port_table(ragged)
        sym = np.stack([gold[f"{nm}__data"] for nm in names]).astype(
            np.int32).reshape(len(names), n)
        idx = np.repeat(np.arange(len(names), dtype=np.int32)[:, None], n, 1)
        buf, lens = _port_encode(sym, idx, table)
        dec, ok = _port_decode(buf, lens, idx, table)
        if n >= 1000:
            jbuf, jlens, _, _ = jax_coder.encode_streams_sidecar(
                sym, jt, idx)
            jdec, jok = jax_coder.decode_streams_sidecar(
                jbuf, jlens, n, jt, *NO_ESC, indexes=idx)
        else:
            jbuf, jdec, jok = buf, dec, ok
        for i, nm in enumerate(names):
            out[nm] = dict(
                ref=gold[f"{nm}__bytes"].tobytes(), data=sym[i],
                mine=buf[i, : lens[i]].tobytes(), mine_row=buf[i],
                jax_row=jbuf[i], dec=dec[i], ok=ok[i], jdec=jdec[i],
                jok=jok[i])
    return out


@pytest.mark.parametrize("name", _golden_names())
def test_golden_bytes(golden_runs, name):
    run = golden_runs[name]
    assert run["mine"] == run["ref"]
    np.testing.assert_array_equal(run["mine_row"], run["jax_row"])
    np.testing.assert_array_equal(run["dec"], run["data"])
    np.testing.assert_array_equal(run["dec"], run["jdec"])
    assert run["ok"] and run["jok"]


# -- corrupt streams --------------------------------------------------------
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


@pytest.mark.parametrize("kind", ["truncated", "bitflip", "random", "empty",
                                  "tiny"])
@pytest.mark.parametrize("overflow", [False, True])
def test_decode_corrupt_matches_jax(kind, overflow):
    rng = np.random.RandomState(7 + overflow)
    ragged = _mixed_ragged(rng, 5, overflow, (8, 16))
    jt = jax_tables.parse_ragged_cdf(ragged)
    idx = rng.randint(0, 5, (32, 48)).astype(np.int32)
    sym = np.clip(rng.randint(-2, 30, (32, 48)), 0,
                  jt.length[idx] - 2).astype(np.int32)
    buf, lens, _, _ = jax_coder.encode_streams_sidecar(sym, jt, idx)
    cbuf, clens = _corrupt(kind, buf, lens, rng)
    ref, ref_ok = jax_coder.decode_streams_sidecar(
        cbuf, clens, 48, jt, *NO_ESC, indexes=idx)
    mine, ok = _port_decode(cbuf, clens, idx, _port_table(ragged))
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(ok, ref_ok)


# -- sidecar helpers, byte lists, wrappers ---------------------------------
def test_sidecar_extract_and_apply_match_jax():
    rng = np.random.RandomState(4)
    sym = rng.randint(-50, 50, (6, 40)).astype(np.int32)
    esc = np.abs(sym) > 40
    j_idx, j_val, j_cnt, j_ok = jax_coder.sidecar_extract(
        jnp.asarray(sym), jnp.asarray(esc), 64)
    idx, val = torch_coder.sidecar_extract(torch.as_tensor(sym),
                                           torch.as_tensor(esc))
    k = int(j_cnt)
    assert bool(j_ok) and idx.shape[0] == k
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx)[:k])
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val)[:k])
    base = rng.randint(0, 9, sym.shape).astype(np.int32)
    np.testing.assert_array_equal(
        torch_coder.sidecar_apply(torch.as_tensor(base), idx, val).numpy(),
        np.asarray(jax_coder.sidecar_apply(jnp.asarray(base), j_idx, j_val)))


def test_sidecar_flatten_matches_jax_pad_and_rejects_bad_positions():
    pos = np.asarray([[0, 3], [2, 0], [5, 39]], np.int32)
    flat = torch_coder.sidecar_flatten(pos, 6, 40)
    j_idx, _ = jax_coder.sidecar_pad(pos, np.arange(3), 40, 240)
    np.testing.assert_array_equal(flat, j_idx[:3])
    for bad in ([[99, 0]], [[0, 99]], [[-9, 2]], [[7, -40]],
                [[2 ** 30, 2 ** 30]]):
        with pytest.raises(ValueError):
            torch_coder.sidecar_flatten(np.asarray(bad, np.int32), 6, 40)


def test_byte_lists_match_jax():
    strings = [b"", b"\x01", b"abc\x00", b"\xff" * 9]
    buf, lens = torch_coder.from_bytes_list(strings)
    jbuf, jlens = jax_coder.from_bytes_list(strings)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(lens, jlens)
    assert torch_coder.to_bytes_list(buf, lens) == strings


def test_wrappers_check_inputs():
    table = _port_table(_mixed_ragged(np.random.RandomState(0), 2, True,
                                      (8, 12)))
    cdf, meta = table.indexed_arrays()
    sym = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_coder.encode_indexed(sym.long(), sym, cdf, meta, 16)
    with pytest.raises(ValueError):
        cuda_coder.encode_indexed(sym, sym, cdf, meta, 9)
    with pytest.raises(ValueError):
        cuda_coder.encode_indexed(sym, sym, cdf, meta[:1], 16)
    with pytest.raises(ValueError):
        cuda_coder.encode_indexed(sym.t(), sym.t(), cdf, meta, 16)
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_coder.decode_indexed(buf, lens.long(), sym, cdf, meta)
    with pytest.raises(ValueError):
        cuda_coder.decode_indexed(buf[:1], lens, sym, cdf, meta)
    # The in-stream-gamma decode (K3') takes the same inputs.
    with pytest.raises(ValueError):
        cuda_coder.decode_gamma(buf[:1], lens, sym, cdf, meta)
    out, ok = torch_coder.decode_dispatch(buf, lens, 4, table, sym,
                                          in_stream_gamma=True)
    assert out.shape == (2, 4) and ok.shape == (2,)
    # The single-row kernels take a one-row table.
    with pytest.raises(ValueError):
        cuda_coder.encode_single_row(sym, cdf, meta, 16)
    with pytest.raises(ValueError):
        cuda_coder.decode_single_row(buf, lens, 4, cdf, meta)


def test_dispatch_log_is_thread_local():
    torch_coder.DISPATCH_LOG["encode"] = "plain-indexed"
    seen = []
    t = threading.Thread(
        target=lambda: seen.append(torch_coder.DISPATCH_LOG.get("encode")))
    t.start()
    t.join()
    assert seen == [None]
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
