"""The port's multi-process paths on gloo ranks (CPU processes), held
against the JAX package in this process (counterpart of
tests/test_multihost.py).

Each scenario is one spawn of ``tests/torch_parallel_worker.py`` (no JAX
there), joined under a time limit that kills the ranks when it expires:
* 2 ranks, ``coding``: the tables built on rank 0 only (rank 1's build_fn
  raises if called) and broadcast; ``gather_bytes`` of each rank's
  ``encode_streams`` shard against JAX's single-process ``encode_streams``
  of the full 8 x 32 batch, also with unequal stream counts and widths;
  the sidecar phase of tests/multihost_worker.py; two bls2017
  data-parallel steps (4 filters, 4 x 16x16x3, Adam 1e-3) with each rank's
  slice of JAX's noise, against JAX's single-process steps.
* 4 ranks, ``dptp``: two bmshj2018 steps (8 filters, 4 scales) on a (2, 2)
  mesh with ``dp_tp_train_step``, against JAX's single-process steps; the
  three ``hyper_synthesis`` kernels and their Adam moments held as
  [..., 4] slices.
Parameters within rtol 1e-5, atol 1e-6 (tests/test_multihost.py's); for
DP x TP within atol 1e-5 (a hundredth of one Adam step at lr 1e-3), and
its first step's gradients within 1e-5 of each one's largest magnitude:
summed over the batch in other orders, a gradient at ~1e-6 of its
largest (bmshj2018's analysis.layer_1.kernel_rdft, -3.11e-7 of 0.31)
carries float32 noise of ~10% of itself, which Adam's normalized step
turns into up to 3.4e-6 of a parameter.  JAX's single-process steps and
the port's agree within the tighter tolerance; the noise is the
re-association of the batch sum, not the parallel code.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from compression_tpu.codec import jax_coder, tables as jax_tables
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel
from compression_tpu.models import bls2017 as jax_bls
from compression_tpu.models import bmshj2018 as jax_bmshj
from compression_tpu_torch.models import bls2017, bmshj2018

import torch_parallel_worker as worker

torch.set_num_threads(1)

LR = 1e-3
STEPS = 2
RTOL, ATOL = 1e-5, 1e-6
DPTP_ATOL = 1e-5
GRAD_TOL = 1e-5
SPAWN_TIMEOUT = 180


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_steps(module, model, params, batch, noise):
    """STEPS of JAX's make_train_step with optax.adam(LR), keys split from
    PRNGKey(7); returns (params, metrics, [each step's noise, as
    ``noise(key)`` gives it])."""
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = module.make_train_step(model, optimizer)
    key = jax.random.PRNGKey(7)
    us = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        us.append(noise(sub))
        params, opt_state, metrics = step(params, opt_state,
                                          jnp.asarray(batch), sub)
    return _np(params), _np(metrics), us


def _uniform(key, shape):
    """The noise JAX's perturb_and_apply draws from ``key``."""
    return np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


def _run(scenario, world, inputs, tmp_path):
    in_path = str(tmp_path / "inputs.npz")
    np.savez(in_path, **inputs)
    results = worker.spawn(scenario, world, in_path, str(tmp_path),
                           SPAWN_TIMEOUT)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} ({'killed' if rc is None else rc}):" \
            f"\n{out[-3000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _assert_params(got, want_state, what, atol=ATOL):
    for k, v in want_state.items():
        np.testing.assert_allclose(got[f"param/{k}"], v.numpy(), rtol=RTOL,
                                   atol=atol, err_msg=f"{what}: {k}")


# -- 2 ranks: tables, byte gather, sidecar, DP steps -------------------------
@pytest.fixture(scope="module")
def coding(tmp_path_factory):
    model = jax_bls.BLS2017Model(lmbda=0.01, num_filters=4)
    params = jax.jit(lambda k, x: model.init(k, x, training=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    batch = np.asarray(np.random.RandomState(5).randint(0, 256, (4, 16, 16,
                                                                 3)),
                       np.float32)
    shape = jax.eval_shape(lambda p, x: model.apply(
        p, x, method=jax_bls.BLS2017Model.encode), params, batch).shape
    start = bls2017.params_from_jax(_np(params))
    after, metrics, us = _jax_steps(jax_bls, model, params, batch,
                                    lambda k: _uniform(k, shape))
    inputs = {"num_filters": 4, "lr": LR, "steps": STEPS, "batch": batch,
              **{f"u{i}": u for i, u in enumerate(us)},
              **{f"param/{k}": v.numpy() for k, v in start.items()}}
    ranks = _run("coding", 2, inputs,
                 tmp_path_factory.mktemp("torch_multihost_coding"))
    return {"ranks": ranks, "batch": batch, "us": us, "start": start,
            "jax_params": bls2017.params_from_jax(after),
            "jax_metrics": metrics}


def test_tables_broadcast_from_rank_0(coding):
    """Rank 1's build_fn raises if called (it ran to its end), and the
    table every rank holds is JAX's build of rank 0's pmf."""
    pmf = 1.0 / (1 + np.arange(16)) ** 1.3
    pmf /= pmf.sum()
    cdf = jax_tables.pmf_to_quantized_cdf(pmf, 10)
    for r in coding["ranks"]:
        np.testing.assert_array_equal(
            r["ragged"], jax_tables.build_ragged_cdf([cdf], [10], [False]))
        np.testing.assert_array_equal(
            r["wide_ragged"], jax_tables.build_ragged_cdf([cdf], [10], [True]))


@pytest.mark.parametrize("rank", [0, 1])
def test_gather_bytes_equals_single_process_encode(coding, rank):
    data = coding["ranks"][rank]
    table = jax_tables.parse_ragged_cdf(data["ragged"])
    buf, lens = jax_coder.encode_streams(data["symbols"], table)
    np.testing.assert_array_equal(data["lengths"], lens)
    np.testing.assert_array_equal(data["buf"], buf)
    sym, sanity = jax_coder.decode_streams(
        data["buf"], data["lengths"], data["symbols"].shape[1], table)
    np.testing.assert_array_equal(sym, data["symbols"])
    assert bool(np.all(sanity))


@pytest.mark.parametrize("rank", [0, 1])
def test_gather_bytes_with_unequal_widths_and_counts(coding, rank):
    """5 streams with escapes on rank 0, 3 without on rank 1: the ranks'
    buffers differ in width, and the gather equals JAX's single-process
    encode of the 8 streams, padding included."""
    data = coding["ranks"][rank]
    widths = [int(r["local_width"]) for r in coding["ranks"]]
    assert widths[0] > widths[1], widths
    table = jax_tables.parse_ragged_cdf(data["wide_ragged"])
    buf, lens = jax_coder.encode_streams(data["wide_symbols"], table)
    np.testing.assert_array_equal(data["wide_lengths"], lens)
    np.testing.assert_array_equal(data["wide_buf"], buf)
    sym, sanity = jax_coder.decode_streams(
        data["wide_buf"], data["wide_lengths"], 32, table)
    np.testing.assert_array_equal(sym, data["wide_symbols"])
    assert bool(np.all(sanity))


def test_sidecar_across_processes(coding):
    """tests/test_multihost.py's phase 1b: the gathered bytes and escape
    sidecar equal JAX's single-process compress_sidecar with the broadcast
    tables, and decode to the quantized rows."""
    data = coding["ranks"][0]
    em = ContinuousBatchedEntropyModel.from_config(dict(
        coding_rank=3, compression=True, stateless=False,
        expected_grads=False, tail_mass=2 ** -8,
        cdf_shapes=(int(data["em_cdf"].shape[0]),
                    int(data["em_off"].shape[0])),
        prior_shape=(4,), offset_heuristic=False,
        quantization_offset=False))
    em.set_weights([data["em_cdf"], data["em_off"]])
    rows = data["sidecar_rows"]
    buf1, len1, ep1, ev1 = em.compress_sidecar(rows)
    assert (jax_coder.to_bytes_list(np.asarray(buf1).reshape(8, -1),
                                    np.asarray(len1).reshape(-1))
            == jax_coder.to_bytes_list(data["sidecar_buf"],
                                       data["sidecar_lens"]))
    n_elem = int(np.prod(rows.shape[1:]))
    pos1 = (ep1.reshape(-1, 2)[:, 0] * n_elem
            + ep1.reshape(-1, 2)[:, 1]).astype(np.int64)
    np.testing.assert_array_equal(pos1, data["sidecar_esc_pos"])
    np.testing.assert_array_equal(np.asarray(ev1), data["sidecar_esc_val"])
    out_rows = em.decompress_sidecar(
        np.asarray(buf1).reshape(8, -1), np.asarray(len1).reshape(-1),
        rows.shape[1:-1],
        np.stack(np.divmod(data["sidecar_esc_pos"], n_elem), 1),
        data["sidecar_esc_val"])
    np.testing.assert_array_equal(out_rows.reshape(rows.shape),
                                  np.asarray(em.quantize(rows)))


@pytest.mark.parametrize("rank", [0, 1])
def test_data_parallel_steps_match_jax(coding, rank):
    _assert_params(coding["ranks"][rank], coding["jax_params"], "2-rank DP")
    for name in ("loss", "bpp", "mse"):
        np.testing.assert_allclose(
            coding["ranks"][rank][f"metric/{name}"],
            coding["jax_metrics"][name], rtol=RTOL, err_msg=name)


def test_data_parallel_steps_match_the_single_process_port(coding):
    model = bls2017.BLS2017Model(num_filters=4)
    model.load_state_dict(coding["start"])
    step = bls2017.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    for u in coding["us"]:
        step(coding["batch"], u=torch.from_numpy(u.copy()))
    _assert_params(coding["ranks"][0], model.state_dict(), "port")


# -- 4 ranks, mesh (2, 2): DP x TP --------------------------------------------
HYPER_KERNELS = ["hyper_synthesis.layer_0.kernel",
                 "hyper_synthesis.layer_1.kernel",
                 "hyper_synthesis.layer_2.kernel"]


@pytest.fixture(scope="module")
def dptp(tmp_path_factory):
    model = jax_bmshj.BMSHJ2018Model(num_filters=8, num_scales=4)
    batch = np.asarray(np.random.RandomState(6).randint(0, 256, (4, 64, 64,
                                                                 3)),
                       np.float32)
    params = jax.jit(lambda k, x: model.init(k, x, training=False))(
        jax.random.PRNGKey(0), jnp.asarray(batch))
    y, z = jax.eval_shape(lambda p, x: model.apply(
        p, x, method=jax_bmshj.BMSHJ2018Model.encode), params, batch)

    def noise(key):
        k1, k2 = jax.random.split(key)
        return _uniform(k1, z.shape), _uniform(k2, y.shape)

    start = bmshj2018.params_from_jax(_np(params))
    first_key = jax.random.split(jax.random.PRNGKey(7))[1]
    grads = jax.jit(jax.grad(lambda p: model.apply(
        p, jnp.asarray(batch), training=True, key=first_key)[0]))(params)
    after, metrics, us = _jax_steps(jax_bmshj, model, params, batch, noise)
    inputs = {"num_filters": 8, "num_scales": 4, "lr": LR, "steps": STEPS,
              "batch": batch,
              **{f"u{i}_z": u[0] for i, u in enumerate(us)},
              **{f"u{i}_y": u[1] for i, u in enumerate(us)},
              **{f"param/{k}": v.numpy() for k, v in start.items()}}
    ranks = _run("dptp", 4, inputs,
                 tmp_path_factory.mktemp("torch_multihost_dptp"))
    return {"ranks": ranks, "jax_params": bmshj2018.params_from_jax(after),
            "jax_metrics": metrics,
            "jax_grads": bmshj2018.params_from_jax(_np(grads))}


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_dp_tp_steps_match_jax(dptp, rank):
    data = dptp["ranks"][rank]
    assert tuple(data["coords"]) == (rank // 2, rank % 2)
    _assert_params(data, dptp["jax_params"], f"DP x TP rank {rank}",
                   atol=DPTP_ATOL)
    for name in ("loss", "bpp", "mse"):
        np.testing.assert_allclose(data[f"metric/{name}"],
                                   dptp["jax_metrics"][name], rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_dp_tp_first_gradients_match_jax(dptp, rank):
    """The first step's gradients, averaged over the data axis, against
    JAX's on the global batch: within 1e-5 of each one's largest."""
    data = dptp["ranks"][rank]
    errors = {}
    for k, v in dptp["jax_grads"].items():
        want = v.numpy()
        errors[k] = float(np.abs(data[f"grad/{k}"] - want).max()
                          / np.abs(want).max())
    assert max(errors.values()) < GRAD_TOL, errors


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_tp_leaves_and_adam_moments_stay_sharded(dptp, rank):
    """The three hyper_synthesis kernels (5,5,8,8), (5,5,8,8), (3,3,8,8)
    are the only TP leaves; each rank's optimizer holds its [..., 4]
    slice and slices of Adam's moments, and the slice is JAX's."""
    data = dptp["ranks"][rank]
    j = rank % 2
    assert sorted(k[len("shard/"):] for k in data
                  if k.startswith("shard/")) == HYPER_KERNELS
    assert data["in_optimizer"].all()
    for name in HYPER_KERNELS:
        full = dptp["jax_params"][name].numpy()
        for kind in ("shard", "exp_avg", "exp_avg_sq"):
            assert data[f"{kind}/{name}"].shape == full.shape[:-1] + (4,)
        np.testing.assert_allclose(data[f"shard/{name}"],
                                   full[..., 4 * j:4 * (j + 1)], rtol=RTOL,
                                   atol=DPTP_ATOL)
