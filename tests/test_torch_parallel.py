"""The port's sharded coding and mesh helpers on in-process CPU meshes,
held against the JAX package on its 8 virtual CPU devices (counterpart of
tests/test_parallel.py).

* ``make_mesh``: the factorization of JAX's for 1-8 devices and explicit
  data axes, the raise included.
* ``BatchCodec``: bytes equal to ``jax_coder.encode_streams`` (as byte
  lists, and the padded arrays equal to the port's unsharded call) and the
  round trip, on test_parallel.py's table at 24 x 100 and 13 x 64, on
  multi-row tables (K1 / K2, and K1 / K3' with overflow), the timer's
  phases against JAX's BatchCodec's.
* The escape fault of the reference: JAX's ``BatchCodec.encode`` codes a
  batch with escapes as escape-free (``encode_dispatch`` with one micro-op
  slot a symbol, jax_coder.py:1118-1127), so its bytes differ from
  ``encode_streams``, rows 0 and 5 decode wrong and every sanity flag is
  True.  The port's BatchCodec codes escapes as ``encode_streams`` does.
* ``SidecarBatchCodec`` with escapes at 16 and 13 streams: bytes equal to
  JAX's unsharded ``compress_sidecar``, escape positions and values equal
  to JAX's sharded codec's first ``count`` entries, the decode equal to
  ``quantize``; the EM's tables carried from the JAX model.
* ``sharded_encode`` over a micro-op closure (K7' and K6's micro-op mode):
  bytes equal to ``encode_streams``.
* ``tp_shardings_like``: each parameter's decision equal to JAX's spec for
  the same leaf, bls2017 and bmshj2018 at small widths, on meshes (8, 1),
  (4, 2), (2, 4) and a 1-D one.
* The train steps on an in-process mesh: a 1 x 1 mesh gives
  make_train_step's results; more than one device raises.
* ``math_ops.parameter_gradient_reduction``, the DP steps' hook at a
  bound's gate: a parameter's gradient is reduced before the gate, a
  tensor computed from data is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from compression_tpu import distributions as jax_dist
from compression_tpu.codec import jax_coder, tables as jax_tables
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JEM
from compression_tpu.models import bls2017 as jax_bls
from compression_tpu.models import bmshj2018 as jax_bmshj
from compression_tpu.parallel import BatchCodec as JaxBatchCodec
from compression_tpu.parallel import SidecarBatchCodec as JaxSidecarCodec
from compression_tpu.parallel import make_mesh as jax_make_mesh
from compression_tpu.parallel import sharding as jax_sharding
from compression_tpu_torch.codec import tables, torch_coder
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.models import bls2017, bmshj2018
from compression_tpu_torch.ops import math_ops
from compression_tpu_torch.parallel import (
    BatchCodec, SidecarBatchCodec, make_mesh, sharded_encode, shard_batch,
    replicate, data_parallel_train_step)
from compression_tpu_torch.parallel import sharding

torch.set_num_threads(1)


def _mesh(n=8, data_axis=None):
    return make_mesh(n, data_axis=data_axis, device="cpu")


def _one_row_table(n, overflow):
    pmf = np.ones(n) / n
    cdf = jax_tables.pmf_to_quantized_cdf(pmf, 10)
    return jax_tables.build_ragged_cdf([cdf], [10], [overflow])


@pytest.fixture(scope="module")
def table():
    """tests/test_parallel.py's table: one uniform row of 16, no overflow."""
    return _one_row_table(16, False)


def _tables(ragged):
    """(JAX CdfTable, the port's CdfTable) of one ragged table."""
    return (jax_tables.parse_ragged_cdf(ragged),
            tables.parse_ragged_cdf(np.asarray(ragged, np.int32)))


def _unsharded(symbols, host, indexes=None):
    dt = torch_coder.DeviceCdfTable(host, "cpu")
    buf, lens = torch_coder.encode_streams(
        torch.as_tensor(symbols), dt,
        None if indexes is None else torch.as_tensor(indexes))
    return buf.numpy(), lens.numpy()


def _check_codec(codec, symbols, host, jax_table, indexes=None):
    """Bytes equal JAX's encode_streams and the port's unsharded arrays;
    decode gives the symbols back with every sanity flag set."""
    buf, lens = codec.encode(symbols, indexes)
    jbuf, jlens = jax_coder.encode_streams(symbols, jax_table,
                                           indexes=indexes)
    assert (jax_coder.to_bytes_list(buf, lens)
            == jax_coder.to_bytes_list(np.asarray(jbuf), np.asarray(jlens)))
    ubuf, ulens = _unsharded(symbols, host, indexes)
    np.testing.assert_array_equal(buf, ubuf)
    np.testing.assert_array_equal(lens, ulens)
    decoded, sanity = codec.decode(buf, lens, symbols.shape[1], indexes)
    np.testing.assert_array_equal(decoded, symbols)
    assert sanity.all()


# -- make_mesh -----------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorization_matches_jax(n):
    want = jax_make_mesh(n)
    got = _mesh(n)
    assert got.axis_names == want.axis_names == ("data", "model")
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert not got.distributed and got.group is None


@pytest.mark.parametrize("n,data_axis", [(8, 8), (8, 4), (8, 2), (8, 1),
                                         (6, 3), (6, 2), (8, 3), (6, 4),
                                         (5, 2)])
def test_mesh_explicit_data_axis_matches_jax(n, data_axis):
    try:
        want = dict(jax_make_mesh(n, data_axis=data_axis).shape)
    except ValueError:
        with pytest.raises(ValueError, match="Cannot factor"):
            _mesh(n, data_axis)
        return
    assert _mesh(n, data_axis).shape == want


def test_mesh_needs_the_cards_it_names():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


def test_shard_batch_and_replicate():
    mesh = _mesh(8)  # (4, 2)
    x = np.arange(8 * 3).reshape(8, 3)
    shards = shard_batch(mesh, {"x": x, "y": [torch.arange(4)]})
    assert [s.tolist() for s in shards["x"]] == [
        x[2 * i:2 * i + 2].tolist() for i in range(4)]
    assert [s.tolist() for s in shards["y"][0]] == [[0], [1], [2], [3]]
    copies = replicate(mesh, torch.ones(3))
    assert len(copies) == 8 and all(torch.equal(c, torch.ones(3))
                                    for c in copies)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, np.zeros((6, 2)))


# -- BatchCodec ------------------------------------------------------------------
@pytest.mark.parametrize("shape,seed", [((24, 100), 0), ((13, 64), 1),
                                        ((3, 40), 2)])
def test_batch_codec_matches_unsharded_encode(table, shape, seed):
    """test_parallel.py's cases (24 x 100, and 13 streams, which do not
    divide over the data axis) and fewer streams than data devices."""
    jt, host = _tables(table)
    symbols = np.random.RandomState(seed).randint(0, 16, shape).astype(
        np.int32)
    codec = BatchCodec(host, _mesh(8))
    _check_codec(codec, symbols, host, jt)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-single"
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-single"


def _multi_row(overflow):
    rng = np.random.RandomState(4)
    cdfs = []
    for r in range(5):
        pmf = rng.uniform(0.05, 1.0, 6 + 3 * r)
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf / pmf.sum(), 12))
    return jax_tables.build_ragged_cdf(cdfs, [12] * 5, [overflow] * 5)


@pytest.mark.parametrize("overflow,expect", [
    (False, ("plain-indexed", "plain-indexed")),
    (True, ("plain-indexed", "plain-gamma"))])
@pytest.mark.parametrize("channel_mode", [False, True])
def test_batch_codec_multi_row_tables(overflow, expect, channel_mode):
    """Five rows of 6-18 symbols at precision 12: K1 to encode, K2 (no
    overflow) or K3' (overflow rows, escape-free data) to decode."""
    jt, host = _tables(_multi_row(overflow))
    rng = np.random.RandomState(5)
    indexes = None if channel_mode else rng.randint(0, 5, (20, 48)).astype(
        np.int32)
    rows = np.arange(48) % 5 if channel_mode else indexes
    symbols = (rng.randint(0, 1000, (20, 48))
               % (np.asarray(host.length)[rows] - 2)).astype(np.int32)
    _check_codec(BatchCodec(host, _mesh(8, 8)), symbols, host, jt, indexes)
    assert (torch_coder.DISPATCH_LOG["encode"],
            torch_coder.DISPATCH_LOG["decode"]) == expect


def test_batch_codec_timer_phases_match_jax(table):
    jt, host = _tables(table)
    symbols = np.zeros((8, 64), np.int32)
    jcodec = JaxBatchCodec(jt, jax_make_mesh())
    codec = BatchCodec(host, _mesh(8))
    for c in (jcodec, codec):
        buf, lens = c.encode(symbols)
        c.encode(symbols)
        c.decode(buf, lens, 64)
    want, got = jcodec.timer.summary(), codec.timer.summary()
    assert list(got) == list(want) == sorted(
        f"{d}{p}" for d in ("encode", "decode")
        for p in ("", "_put", "_compute", "_gather"))
    for name in want:
        assert set(got[name]) == set(want[name]) == {"total_s", "count",
                                                     "mean_ms"}
        assert got[name]["count"] == want[name]["count"]
        assert abs(got[name]["mean_ms"] - 1e3 * got[name]["total_s"]
                   / got[name]["count"]) <= 1e-3


@pytest.fixture(scope="module")
def escape_probe():
    """16 streams x 64 symbols on a one-row overflow table of 8 symbols,
    escapes planted at [0, 3] = 40 and [5, 10] = -7."""
    ragged = _one_row_table(8, True)
    symbols = np.random.RandomState(7).randint(0, 6, (16, 64)).astype(
        np.int32)
    symbols[0, 3], symbols[5, 10] = 40, -7
    return ragged, symbols


def test_jax_batch_codec_corrupts_batches_with_escapes(escape_probe):
    """The fault of the reference the port does not copy (ROADMAP §3): its
    bytes differ from encode_streams, rows 0 and 5 decode wrong, and
    every sanity flag is True."""
    ragged, symbols = escape_probe
    jt, _ = _tables(ragged)
    codec = JaxBatchCodec(jt, jax_make_mesh())
    buf, lens = codec.encode(symbols)
    jbuf, jlens = jax_coder.encode_streams(symbols, jt)
    assert (jax_coder.to_bytes_list(buf, lens)
            != jax_coder.to_bytes_list(np.asarray(jbuf), np.asarray(jlens)))
    decoded, sanity = codec.decode(buf, lens, 64)
    wrong = sorted(set(np.nonzero(decoded != symbols)[0].tolist()))
    assert wrong == [0, 5]
    assert sanity.all()


def test_port_batch_codec_codes_escapes(escape_probe):
    """The same batch through the port's BatchCodec: encode_streams' bytes
    (K6' with in-stream Elias gamma), and the round trip."""
    ragged, symbols = escape_probe
    jt, host = _tables(ragged)
    _check_codec(BatchCodec(host, _mesh(8)), symbols, host, jt)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"


# -- SidecarBatchCodec -------------------------------------------------------
@pytest.fixture(scope="module")
def ems():
    """test_parallel.py's EM (DeepFactorized over 8 channels from
    PRNGKey(2)) and the port's EM carrying its tables."""
    prior = jax_dist.UniformNoiseAdapter(jax_dist.DeepFactorized(
        params=jax_dist.DeepFactorized.init_params(
            jax.random.PRNGKey(2), (8,)), batch_shape=(8,)))
    jem = JEM(prior=prior, coding_rank=3, compression=True)
    weights = [np.asarray(w) for w in jem.get_weights()]
    offset = weights[2] if len(weights) == 3 else None
    pem = ContinuousBatchedEntropyModel(
        prior_shape=(8,), cdf=weights[0], cdf_offset=weights[1],
        quantization_offset=offset, coding_rank=3, compression=True,
        device="cpu")
    return jem, pem


def _rows(s, seed):
    rng = np.random.RandomState(seed)
    rows = rng.normal(0, 2, size=(s, 1, 16, 8)).astype(np.float32)
    rows[0, 0, 0, 0] = 500.0
    rows[1, 0, 1, 1] = -400.0
    rows[s - 1, 0, 15, 7] = 300.0
    return rows


@pytest.mark.parametrize("s,seed", [(16, 3), (13, 5), (5, 6)])
def test_sidecar_batch_codec_matches_jax(ems, s, seed):
    jem, pem = ems
    rows = _rows(s, seed)
    codec = SidecarBatchCodec(pem, _mesh(8))
    buf, lens, esc_idx, esc_val = codec.encode(rows)
    jbuf, jlens, _, _ = jem.compress_sidecar(rows)
    assert (jax_coder.to_bytes_list(buf, lens)
            == jax_coder.to_bytes_list(np.asarray(jbuf).reshape(s, -1),
                                       np.asarray(jlens).reshape(-1)))
    _, _, jei, jev, count, ok = JaxSidecarCodec(jem, jax_make_mesh()).encode(
        rows)
    assert ok and int(count) == esc_idx.size >= 3
    assert esc_idx.dtype == np.int64 and (np.diff(esc_idx) > 0).all()
    np.testing.assert_array_equal(esc_idx, jei[:int(count)])
    np.testing.assert_array_equal(esc_val, jev[:int(count)])
    out, sanity = codec.decode(buf, lens, (1, 16), esc_idx, esc_val)
    assert sanity.all()
    np.testing.assert_array_equal(out, np.asarray(jem.quantize(rows)))
    np.testing.assert_array_equal(out, pem.quantize(torch.as_tensor(
        rows)).numpy())
    for bad in (-1, s * 16 * 8):
        with pytest.raises(ValueError, match="outside the stream grid"):
            codec.decode(buf, lens, (1, 16), np.append(esc_idx, bad),
                         np.append(esc_val, 7))
    assert set(codec.timer.summary()) == {
        f"{d}{p}" for d in ("encode", "decode")
        for p in ("", "_put", "_compute", "_gather")}


def test_em_moved_to_another_device_shares_its_tables(ems):
    _, pem = ems
    assert pem.to("cpu") is pem


# -- sharded_encode ------------------------------------------------------------
def test_sharded_encode_micro_op_closure_matches_encode_streams():
    """JAX's docstring example (micro_ops_from_symbols + encode_core) on
    the escape probe's overflow table, 16 streams with escapes over a
    data axis of 4: K7' and K6's micro-op mode in each shard."""
    ragged = _one_row_table(8, True)
    jt, host = _tables(ragged)
    dt = torch_coder.DeviceCdfTable(host, "cpu")
    symbols = np.random.RandomState(8).randint(0, 6, (16, 40)).astype(
        np.int32)
    symbols[2, 5], symbols[9, 0] = 300, -20
    indexes = np.zeros_like(symbols)
    slots, num_steps = 2 * 16 + 3, 256
    out_size = torch_coder.stream_out_size(num_steps)

    def encode_fn(s, i):
        ops = torch_coder.micro_ops_from_symbols(s, i, dt, slots, num_steps)
        return torch_coder.encode_core(*ops, out_size)

    buf, lens = sharded_encode(_mesh(8), encode_fn, symbols, indexes)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-micro"
    jbuf, jlens = jax_coder.encode_streams(symbols, jt)
    assert (jax_coder.to_bytes_list(buf, lens)
            == jax_coder.to_bytes_list(np.asarray(jbuf), np.asarray(jlens)))
    with pytest.raises(ValueError, match="does not divide"):
        sharded_encode(_mesh(8), encode_fn, symbols[:15], indexes[:15])


# -- tp_shardings_like ---------------------------------------------------------
def _jax_meshes():
    devices = np.asarray(jax.devices())
    return {"8x1": (jax_make_mesh(8, data_axis=8), _mesh(8, 8)),
            "4x2": (jax_make_mesh(8), _mesh(8)),
            "2x4": (jax_make_mesh(8, data_axis=2), _mesh(8, 2)),
            "1d": (JaxMesh(devices, ("data",)),
                   sharding.Mesh(np.asarray([torch.device("cpu")] * 8,
                                            dtype=object), ("data",)))}


@pytest.mark.parametrize("mesh_name", ["8x1", "4x2", "2x4", "1d"])
@pytest.mark.parametrize("family", ["bls2017", "bmshj2018"])
def test_tp_shardings_like_matches_jax(family, mesh_name):
    """Each port parameter's decision equals JAX's spec for its leaf (the
    leaves carried by params_from_jax, which keeps their shapes)."""
    jax_mesh, mesh = _jax_meshes()[mesh_name]
    if family == "bls2017":
        jmodel = jax_bls.BLS2017Model(num_filters=8)
        port, model = bls2017, bls2017.BLS2017Model(num_filters=8)
    else:
        jmodel = jax_bmshj.BMSHJ2018Model(num_filters=8, num_scales=4)
        port = bmshj2018
        model = bmshj2018.BMSHJ2018Model(num_filters=8, num_scales=4)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=False))
    specs = jax_sharding.tp_shardings_like(jax_mesh, shapes)
    flags = jax.tree_util.tree_map(
        lambda x, s: np.full(x.shape, float(tuple(s.spec) != ()),
                             np.float32), shapes, specs)
    want = {k: bool((v != 0).any())
            for k, v in port.params_from_jax(flags).items()}
    got = sharding.tp_shardings_like(mesh, model.named_parameters())
    assert set(got) == set(want)
    assert {k: got[k] != () for k in got} == want
    sharded = sorted(k for k, v in got.items() if v)
    if family == "bmshj2018" and mesh_name in ("4x2", "2x4"):
        assert sharded == [f"hyper_synthesis.layer_{i}.kernel"
                           for i in range(3)]
        assert all(got[k] == (None, None, None, "model") for k in sharded)
    else:
        assert sharded == []


# -- the train steps on an in-process mesh -------------------------------------
def test_steps_on_a_one_device_mesh_equal_make_train_step():
    x = np.random.RandomState(3).randint(0, 256, (2, 32, 32, 3)).astype(
        np.float32)
    u = torch.rand((2, 2, 2, 8), generator=torch.Generator().manual_seed(
        1)) - 0.5
    results = []
    for kind in ("make_train_step", "data_parallel", "dp_tp"):
        model = bls2017.BLS2017Model(num_filters=8)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        if kind == "make_train_step":
            step = bls2017.make_train_step(model, opt)
        elif kind == "data_parallel":
            step = data_parallel_train_step(_mesh(1), model, opt)
        else:
            step, model, opt = sharding.dp_tp_train_step(_mesh(1), model, opt)
            assert step.shards == {}
        metrics = [step(x, u=u) for _ in range(2)][-1]
        results.append((model.state_dict(), metrics))
    for state, metrics in results[1:]:
        for k, v in results[0][0].items():
            assert torch.equal(state[k], v), k
        for k, v in results[0][1].items():
            assert torch.equal(metrics[k], v), k


@pytest.mark.parametrize("make", [data_parallel_train_step,
                                  sharding.dp_tp_train_step])
def test_steps_refuse_an_in_process_mesh_of_several_devices(make):
    model = bls2017.BLS2017Model(num_filters=4)
    with pytest.raises(ValueError, match="process mesh"):
        make(_mesh(2), model, torch.optim.Adam(model.parameters()))


def test_codec_default_meshes(table, ems):
    """Over a host table BatchCodec takes every card (and raises without
    one); a table or a model on the CPU gives a one-entry CPU mesh."""
    host = _tables(table)[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchCodec(host)
    cpu_table = torch_coder.DeviceCdfTable(host, "cpu")
    assert BatchCodec(cpu_table).mesh.shape == {"data": 1, "model": 1}
    assert SidecarBatchCodec(ems[1]).mesh.shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("op,sign", [(math_ops.lower_bound, 1.0),
                                     (math_ops.upper_bound, -1.0)])
def test_gradient_reduction_before_a_bounds_gate(op, sign):
    """A parameter past its bound: the gate passes only a gradient that
    moves it toward the bound, judged on the reduced gradient when a
    reduction is active; a non-leaf input is never reduced."""
    def grads(reduce, leaf=True):
        p = torch.full((3,), -sign, requires_grad=True)
        x = p if leaf else p * 1.0
        with math_ops.parameter_gradient_reduction(reduce):
            y = op(x, 0.0)
        (y * torch.tensor([sign, sign, -sign])).sum().backward()
        return p.grad.tolist()

    flip = lambda g: -g  # noqa: E731 (a "global" gradient of the other sign)
    assert grads(None) == [0.0, 0.0, -sign]
    assert grads(flip) == [-sign, -sign, 0.0]
    assert grads(flip, leaf=False) == [0.0, 0.0, -sign]
