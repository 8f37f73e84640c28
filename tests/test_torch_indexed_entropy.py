"""The port's Normal / NoisyNormal distributions and indexed entropy models
against the JAX package and the reference's golden fixtures.

Tolerances: distribution values within 1e-6 relative plus 1.2e-7 absolute
(one float32 step at 1.0: a CDF is computed as a difference from 1, so its
far tail is only that accurate in either package), eval bits within 1e-5
relative; tables, bytes, lengths, ``ok`` flags and decoded values exact.
"""

import math
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from compression_tpu import distributions as jax_dist
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JB
from compression_tpu.entropy_models.continuous_indexed import (
    ContinuousIndexedEntropyModel as JI,
    LocationScaleIndexedEntropyModel as JL)
from compression_tpu.models.bmshj2018 import make_scale_fn as jax_scale_fn
from compression_tpu.ops import math_ops as jax_math_ops
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.distributions import base as dist_base
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    ContinuousIndexedEntropyModel, LocationScaleIndexedEntropyModel)
from compression_tpu_torch.models.bmshj2018 import make_scale_fn
from compression_tpu_torch.ops import math_ops

torch.set_num_threads(1)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-6


def _close(mine, ref, rtol=RTOL, atol=1.2e-7):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol)


# -- distributions ----------------------------------------------------------
@pytest.fixture(scope="module")
def normals():
    rng = np.random.RandomState(0)
    loc = rng.uniform(-3, 3, (7,)).astype(np.float32)
    scale = np.exp(rng.uniform(-2.2, 5.5, (7,))).astype(np.float32)
    x = (loc + scale * rng.standard_normal((50, 7)) * 2).astype(np.float32)
    return loc, scale, x


@pytest.mark.parametrize("method", ["log_prob", "cdf", "survival_function",
                                    "log_cdf", "log_survival_function",
                                    "prob"])
def test_normal_matches_jax(normals, method):
    loc, scale, x = normals
    ref = getattr(jax_dist.Normal(loc, scale), method)(jnp.asarray(x))
    mine = getattr(dist_base.Normal(torch.tensor(loc), torch.tensor(scale)),
                   method)(torch.tensor(x))
    _close(mine, ref)


def test_normal_quantile_mean_shape(normals):
    loc, scale, _ = normals
    ref = jax_dist.Normal(loc, scale)
    mine = dist_base.Normal(torch.tensor(loc), torch.tensor(scale))
    p = np.asarray([2 ** -9, 0.1, 0.5, 0.9, 1 - 2 ** -9], np.float32)[:, None]
    _close(mine.quantile(torch.tensor(p)), ref.quantile(p), rtol=1e-5,
           atol=1e-5)
    _close(mine.mean(), ref.mean())
    _close(mine.mode(), ref.mode())
    assert mine.batch_shape == tuple(ref.batch_shape) == (7,)


@pytest.mark.parametrize("method", ["log_prob", "prob"])
def test_noisy_normal_matches_jax(normals, method):
    """Both of the adapter's paths (sf+cdf and cdf only), tails included."""
    loc, scale, x = normals
    x = np.round(x)
    ref = jax_dist.NoisyNormal(loc=loc, scale=scale)
    mine = uniform_noise.NoisyNormal(loc=torch.tensor(loc),
                                     scale=torch.tensor(scale))
    _close(getattr(mine, method)(torch.tensor(x)),
           getattr(ref, method)(jnp.asarray(x)), rtol=2e-5)
    short = {"log_prob": "_log_prob_with_logcdf", "prob": "_prob_with_cdf"}
    inner = np.clip(x, loc - 2 * scale, loc + 2 * scale)
    _close(getattr(mine, short[method])(torch.tensor(inner)),
           getattr(ref, short[method])(jnp.asarray(inner)), rtol=2e-4,
           atol=1e-7)
    _close(mine.mean(), ref.mean())


def test_noisy_normal_tails_and_offset(normals):
    from compression_tpu.distributions import helpers as jax_helpers
    from compression_tpu_torch.distributions import helpers
    loc, scale, _ = normals
    ref = jax_dist.NoisyNormal(loc=loc, scale=scale)
    mine = uniform_noise.NoisyNormal(loc=torch.tensor(loc),
                                     scale=torch.tensor(scale))
    for name in ("lower_tail", "upper_tail"):
        _close(getattr(helpers, name)(mine, 2 ** -8),
               getattr(jax_helpers, name)(ref, 2 ** -8), rtol=1e-5)
    _close(helpers.quantization_offset(mine),
           jax_helpers.quantization_offset(ref), atol=1e-6)


@pytest.mark.parametrize("gradient", ["disconnected", "identity",
                                      "identity_if_towards"])
def test_upper_bound_gradient_matches_jax(gradient):
    import jax
    x = np.asarray([-1.0, 0.5, 2.0, 3.0, 7.0], np.float32)
    g = np.asarray([1.0, -1.0, 1.0, -2.0, 3.0], np.float32)
    ref_out, vjp = jax.vjp(
        lambda v: jax_math_ops.upper_bound(v, 2.0, gradient), jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    t = torch.tensor(x, requires_grad=True)
    out = math_ops.upper_bound(t, 2.0, gradient)
    out.backward(torch.tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref_grad))
    with pytest.raises(ValueError):
        math_ops.upper_bound(t, 2.0, "sideways")


# -- tables -----------------------------------------------------------------
def _scale_models(num_scales=64, scale_max=256.0, coding_rank=3):
    jem = JL(jax_dist.NoisyNormal, num_scales,
             jax_scale_fn(0.11, scale_max, num_scales),
             coding_rank=coding_rank, compression=True)
    tem = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, num_scales,
        make_scale_fn(0.11, scale_max, num_scales), coding_rank=coding_rank,
        compression=True, device="cpu")
    return jem, tem


@pytest.fixture(scope="module")
def scale_models():
    return _scale_models(16, 64.0)


def test_scale_fn_matches_jax():
    i = np.arange(64, dtype=np.float32)
    # exp differs by one float32 step between the packages at a few
    # indexes; the tables below are equal all the same.
    np.testing.assert_allclose(
        make_scale_fn(0.11, 256.0, 64)(torch.tensor(i)).numpy(),
        np.asarray(jax_scale_fn(0.11, 256.0, 64)(jnp.asarray(i))),
        rtol=1.2e-7)


@pytest.mark.parametrize("fixture", ["golden_bmshj_full.npz",
                                     "golden_bmshj.npz"])
def test_y_table_equals_golden(fixture):
    """The 64-row scale table at the published settings equals the
    reference's, entry for entry (13078 ragged entries, 64 offsets)."""
    gold = np.load(os.path.join(GOLD_DIR, fixture))
    _, tem = _scale_models()
    assert tem.cdf.shape == (13078,)
    np.testing.assert_array_equal(tem.cdf, gold["cdf_y"])
    np.testing.assert_array_equal(tem.cdf_offset, gold["cdf_offset_y"])


def test_y_table_equals_jax(scale_models):
    jem, tem = scale_models
    np.testing.assert_array_equal(tem.cdf, np.asarray(jem.cdf))
    np.testing.assert_array_equal(tem.cdf_offset, np.asarray(jem.cdf_offset))


def _general_models(channel_axis, index_ranges):
    """A two-parameter indexed model (loc and scale from two index
    channels), or a one-range model without a channel axis."""
    if channel_axis is None:
        jfns = dict(loc=lambda i: 0.25 * i, scale=lambda i: 0.5 + 0.7 * i)
        tfns = jfns
    else:
        def pick(i, c):
            return i[..., c] if channel_axis == -1 else i[c]
        jfns = dict(loc=lambda i: 0.5 * pick(i, 0) - 1.0,
                    scale=lambda i: jnp.exp(0.4 * pick(i, 1) - 1.0))
        tfns = dict(loc=lambda i: 0.5 * pick(i, 0) - 1.0,
                    scale=lambda i: torch.exp(0.4 * pick(i, 1) - 1.0))
    jem = JI(jax_dist.NoisyNormal, index_ranges, jfns, coding_rank=2,
             channel_axis=channel_axis, compression=True)
    tem = ContinuousIndexedEntropyModel(
        uniform_noise.NoisyNormal, index_ranges, tfns, coding_rank=2,
        channel_axis=channel_axis, compression=True, device="cpu")
    return jem, tem


GENERAL = {"last_axis": (-1, (4, 6)), "first_axis": (0, (3, 5)),
           "no_axis": (None, (9,))}


def _general_data(name, rng):
    channel_axis, ranges = GENERAL[name]
    shape = (3, 5, 11)
    if channel_axis is None:
        idx = rng.uniform(-2, ranges[0] + 1, shape)
    else:
        chans = [rng.uniform(-2, r + 1, shape) for r in ranges]
        idx = np.stack(chans, axis=channel_axis)
    idx = idx.astype(np.float32)
    y = np.round(rng.laplace(0, 4, shape)).astype(np.float32)
    y[0, 0, :3] = [900, -70000, 65]
    return idx, y


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_indexed_model_matches_jax(name):
    """Multi-dimensional index_ranges on either channel axis and
    channel_axis=None: tables, flat indexes, bytes, round trip, bits."""
    jem, tem = _general_models(*GENERAL[name])
    np.testing.assert_array_equal(tem.cdf, np.asarray(jem.cdf))
    np.testing.assert_array_equal(tem.cdf_offset, np.asarray(jem.cdf_offset))
    idx, y = _general_data(name, np.random.RandomState(1))
    flat_ref = np.asarray(jem._flatten_indexes(jem._normalize_indexes(
        jnp.asarray(idx))))
    flat = tem._flatten_indexes(tem._normalize_indexes(torch.tensor(idx)))
    np.testing.assert_array_equal(flat.numpy(), flat_ref)
    buf, lens = jem.compress(y, idx)
    mine, mine_lens = tem.compress(torch.tensor(y), torch.tensor(idx))
    assert tuple(mine.shape) == buf.shape
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    assert tem.compress_to_strings(torch.tensor(y), torch.tensor(idx)) == \
        jem.compress_to_strings(y, idx)
    dec = tem.decompress(mine, torch.tensor(idx), lengths=mine_lens)
    np.testing.assert_array_equal(dec.numpy(), y)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jem.decompress(buf, idx, lengths=lens)))
    _, ref_bits = jem(y, idx, training=False)
    q, bits = tem(torch.tensor(y), torch.tensor(idx))
    np.testing.assert_array_equal(q.numpy(), y)
    _close(bits, ref_bits, rtol=1e-5)
    # Training mode needs a noise source (a generator or u).
    with pytest.raises(ValueError):
        tem(torch.tensor(y), torch.tensor(idx), training=True)


# -- the location-scale model: every format ----------------------------------
def _ls_data(rng, scale=1.5, outliers=True):
    idx = rng.uniform(-2, 18, (2, 4, 4, 8)).astype(np.float32)
    sigma = np.exp(math.log(0.11) + (math.log(64) - math.log(0.11)) / 15
                   * np.clip(idx, 0, 15))
    y = (rng.standard_normal(idx.shape) * sigma * scale).astype(np.float32)
    if outliers:
        y[0, 0, 0, 0] = 5000.0
        y[1, 1, 1, 1] = -70000.0
    loc = rng.uniform(-3, 3, idx.shape).astype(np.float32)
    return idx, y, loc


@pytest.mark.parametrize("with_loc", [False, True])
def test_location_scale_compress_matches_jax(scale_models, with_loc):
    jem, tem = scale_models
    idx, y, loc = _ls_data(np.random.RandomState(2))
    jloc, tloc = (loc, torch.tensor(loc)) if with_loc else (None, None)
    buf, lens = jem.compress(y, idx, loc=jloc)
    mine, mine_lens = tem.compress(torch.tensor(y), torch.tensor(idx),
                                   loc=tloc)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    strings = tem.compress_to_strings(torch.tensor(y), torch.tensor(idx),
                                      loc=tloc)
    assert strings == jem.compress_to_strings(y, idx, loc=jloc)
    dec = tem.decompress(strings, torch.tensor(idx), loc=tloc)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jem.decompress(strings, idx, loc=jloc)))
    np.testing.assert_array_equal(
        dec.numpy(), tem.quantize(torch.tensor(y), tloc).numpy())
    _, ref_bits = jem(y, idx, loc=jloc, training=False)
    _, bits = tem(torch.tensor(y), torch.tensor(idx), loc=tloc)
    _close(bits, ref_bits, rtol=1e-5)


def test_location_scale_sidecar_matches_jax(scale_models):
    """Sidecar pair: streams and escape list byte-identical to the JAX
    package's compress_sidecar, round trip, JAX decodes ours."""
    jem, tem = scale_models
    idx, y, loc = _ls_data(np.random.RandomState(3))
    buf, lens, esc_pos, esc_val = jem.compress_sidecar(y, idx, loc=loc)
    mine, mine_lens, esc_idx, mine_val = tem.compress_sidecar_device(
        torch.tensor(y), torch.tensor(idx), loc=torch.tensor(loc))
    np.testing.assert_array_equal(mine.numpy(), buf)
    np.testing.assert_array_equal(mine_lens.numpy(), lens)
    n = int(np.prod(y.shape[1:]))
    assert len(esc_pos) >= 2
    np.testing.assert_array_equal(
        esc_idx.numpy(), esc_pos[:, 0].astype(np.int64) * n + esc_pos[:, 1])
    np.testing.assert_array_equal(mine_val.numpy(), esc_val)
    dec, ok = tem.decompress_sidecar_device(
        mine.reshape(2, -1), mine_lens, torch.tensor(idx), esc_idx, mine_val,
        loc=torch.tensor(loc))
    assert bool(ok.all())
    expect = tem.quantize(torch.tensor(y), torch.tensor(loc)).numpy()
    np.testing.assert_array_equal(dec.numpy(), expect)
    np.testing.assert_array_equal(
        np.asarray(jem.decompress_sidecar(
            mine.numpy(), mine_lens.numpy(), idx, esc_pos, esc_val,
            loc=loc)), expect)


# (max_gamma_bits, escape_budget, expected ok)
BUDGETS = {"fits": (17, 64, True), "value_past_gamma_bits": (12, 64, False),
           "default_bits_too_few": (16, 64, False),
           "too_many_escapes": (17, 1, False)}


@pytest.mark.parametrize("name", sorted(BUDGETS))
def test_location_scale_compress_device_matches_jax(scale_models, name):
    """compress_device: bytes, lengths and ``ok`` equal the JAX package's,
    also where the budget does not hold; when it holds, the bytes equal
    compress and decompress_device inverts them."""
    jem, tem = scale_models
    bits, budget, expect_ok = BUDGETS[name]
    idx, y, loc = _ls_data(np.random.RandomState(4))
    buf, lens, ok = jem.compress_device(
        y, idx, loc=loc, max_gamma_bits=bits, escape_budget=budget)
    mine, mine_lens, mine_ok = tem.compress_device(
        torch.tensor(y), torch.tensor(idx), loc=torch.tensor(loc),
        max_gamma_bits=bits, escape_budget=budget)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-micro"
    assert bool(ok) == bool(mine_ok) == expect_ok
    assert tuple(mine.shape) == np.asarray(buf).shape
    np.testing.assert_array_equal(mine.numpy(), np.asarray(buf))
    np.testing.assert_array_equal(mine_lens.numpy(), np.asarray(lens))
    if not expect_ok:
        return
    ref, ref_lens = tem.compress(torch.tensor(y), torch.tensor(idx),
                                 loc=torch.tensor(loc))
    np.testing.assert_array_equal(mine_lens.numpy(), ref_lens.numpy())
    np.testing.assert_array_equal(mine[:, : ref.shape[1]].numpy(),
                                  ref.numpy())
    assert not mine[:, ref.shape[1]:].any()
    dec, sane = tem.decompress_device(mine, mine_lens, torch.tensor(idx),
                                      loc=torch.tensor(loc))
    assert bool(sane.all())
    np.testing.assert_array_equal(
        dec.numpy(),
        tem.quantize(torch.tensor(y), torch.tensor(loc)).numpy())


# -- the batched model's compress_device -------------------------------------
@pytest.fixture(scope="module")
def batched_models():
    gen = torch.Generator().manual_seed(5)
    params = deep_factorized.DeepFactorized.init_params((6,), generator=gen)
    jparams = {k: [jnp.asarray(p.numpy()) for p in v]
               for k, v in params.items()}
    jem = JB(jax_dist.NoisyDeepFactorized(params=jparams, batch_shape=(6,)),
             coding_rank=3, compression=True)
    tem = ContinuousBatchedEntropyModel(
        prior=deep_factorized.NoisyDeepFactorized(
            params=params, batch_shape=(6,)),
        coding_rank=3, compression=True, device="cpu")
    return jem, tem


@pytest.mark.parametrize("name", sorted(BUDGETS))
def test_batched_compress_device_matches_jax(batched_models, name):
    jem, tem = batched_models
    np.testing.assert_array_equal(tem.cdf, np.asarray(jem.cdf))
    bits, budget, expect_ok = BUDGETS[name]
    rng = np.random.RandomState(6)
    z = rng.laplace(0, 6, (3, 4, 5, 6)).astype(np.float32)
    z[0, 0, 0, 0] = 70000.0
    z[2, 1, 1, 1] = -300.0
    z[1, 0] = 70000.0  # 30 escapes in one stream
    buf, lens, ok = jem.compress_device(z, max_gamma_bits=bits,
                                        escape_budget=budget)
    mine, mine_lens, mine_ok = tem.compress_device(
        torch.tensor(z), max_gamma_bits=bits, escape_budget=budget)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-micro"
    assert bool(ok) == bool(mine_ok) == expect_ok
    np.testing.assert_array_equal(mine.numpy(), np.asarray(buf))
    np.testing.assert_array_equal(mine_lens.numpy(), np.asarray(lens))
    if not expect_ok:
        return
    assert torch_coder.to_bytes_list(mine.numpy(), mine_lens.numpy()) == \
        tem.compress_to_strings(torch.tensor(z))
    dec, sane = tem.decompress_device(mine, mine_lens, (4, 5))
    assert bool(sane.all())
    np.testing.assert_array_equal(dec.numpy(),
                                  tem.quantize(torch.tensor(z)).numpy())


def test_compress_device_without_overflow_rows():
    """A table without overflow rows takes the one-slot budget: the
    indexed encode kernel's route, bytes equal to compress."""
    fns = dict(loc=lambda i: 0.0 * i, scale=lambda i: 1.0 + i)
    tem = ContinuousIndexedEntropyModel(
        uniform_noise.NoisyNormal, (5,), fns, coding_rank=1,
        channel_axis=None, compression=True, device="cpu")
    jem = JI(jax_dist.NoisyNormal, (5,), fns, coding_rank=1,
             channel_axis=None, compression=True)
    # Strip the overflow flags: positive precision markers in the ragged
    # table mean bounded rows.
    cdf = np.asarray(jem.cdf).copy()
    cdf[cdf < 0] *= -1
    cdf_offset = np.asarray(jem.cdf_offset)
    tem.set_weights([cdf, cdf_offset])
    jem._init_compression(cdf, cdf_offset, None)
    rng = np.random.RandomState(7)
    idx = rng.randint(0, 5, (4, 33)).astype(np.float32)
    y = np.round(rng.standard_normal(idx.shape) * (1 + idx)).astype(
        np.float32)
    buf, lens, ok = jem.compress_device(y, idx)
    mine, mine_lens, mine_ok = tem.compress_device(torch.tensor(y),
                                                   torch.tensor(idx))
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
    assert bool(ok) and bool(mine_ok)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(buf))
    np.testing.assert_array_equal(mine_lens.numpy(), np.asarray(lens))


# -- golden strings -----------------------------------------------------------
def _strings(gold, prefix):
    nb = gold[f"{prefix}_nbytes"]
    buf = gold[f"{prefix}_bytes"].tobytes()
    out, off = [], 0
    for n in nb:
        out.append(buf[off:off + int(n)])
        off += int(n)
    return out


def test_golden_bmshj_strings_from_golden_latents():
    """golden_bmshj.npz: its y / z latents code to its y_bytes / z_bytes
    through the port's two entropy models on the carried tables, with the
    scale indexes computed by the JAX package's hyper synthesis on the
    fixture's weights."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.port_tf_weights import port_bmshj2018
    from compression_tpu.models import bmshj2018 as jax_bmshj

    gold = np.load(os.path.join(GOLD_DIR, "golden_bmshj.npz"))
    tf_vars = {k[len("var__"):].replace("__", "/"): gold[k]
               for k in gold.files if k.startswith("var__")}
    jm = jax_bmshj.BMSHJ2018Model(num_filters=int(gold["num_filters"]))
    jc = jax_bmshj.BMSHJ2018Codec(jm, port_bmshj2018(tf_vars))
    _, tem = _scale_models()
    side = ContinuousBatchedEntropyModel(
        prior_shape=(int(gold["num_filters"]),), cdf=gold["cdf_z"],
        cdf_offset=gold["cdf_offset_z"],
        quantization_offset=gold["qoffset_z"], coding_rank=3,
        compression=True, device="cpu")
    z = torch.tensor(gold["z"])
    assert side.compress_to_strings(z) == _strings(gold, "z")
    z_hat = side.quantize(z)
    indexes = np.asarray(jc._hyper_decode(jc.params, jnp.asarray(
        z_hat.numpy())))[:, : gold["y"].shape[1], : gold["y"].shape[2], :]
    strings = tem.compress_to_strings(torch.tensor(gold["y"]),
                                      torch.tensor(indexes))
    assert strings == _strings(gold, "y")
    dec = tem.decompress(strings, torch.tensor(indexes))
    np.testing.assert_array_equal(dec.numpy(), np.round(gold["y"]))
    # The budgeted route writes the same strings.
    buf, lens, ok = tem.compress_device(torch.tensor(gold["y"]),
                                        torch.tensor(indexes))
    assert bool(ok)
    assert torch_coder.to_bytes_list(buf.numpy(), lens.numpy()) == strings


def test_golden_em_location_scale_fixture():
    """golden_em.npz's location-scale case (coding_rank 1, with loc):
    table, strings both ways and bits, as tests/test_golden_em.py holds
    the JAX model to."""
    gold = np.load(os.path.join(GOLD_DIR, "golden_em.npz"))
    off = float(gold["lsi__scale_fn_offset"])
    fac = float(gold["lsi__scale_fn_factor"])
    tem = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, int(gold["lsi__num_scales"]),
        lambda i: torch.exp(off + fac * i), coding_rank=1, compression=True,
        device="cpu")
    np.testing.assert_array_equal(tem.cdf, gold["lsi__cdf"])
    np.testing.assert_array_equal(tem.cdf_offset, gold["lsi__cdf_offset"])
    idx = torch.tensor(gold["lsi__indexes"])
    loc = torch.tensor(gold["lsi__loc"])
    x = torch.tensor(gold["lsi__x"])
    strings = _strings(gold, "lsi_")
    assert tem.compress_to_strings(x, idx, loc=loc) == strings
    np.testing.assert_array_equal(
        tem.decompress(strings, idx, loc=loc).numpy(), gold["lsi__xhat"])
    _, bits = tem(x, idx, loc=loc)
    np.testing.assert_allclose(bits.numpy(), gold["lsi__bits"], rtol=1e-4)


def test_indexed_model_checks_arguments():
    with pytest.raises(TypeError):
        ContinuousIndexedEntropyModel("prior", (3,), {}, 1, device="cpu")
    with pytest.raises(TypeError):
        ContinuousIndexedEntropyModel(
            uniform_noise.NoisyNormal, (3,), {"loc": 1.0}, 1, device="cpu")
    with pytest.raises(ValueError):
        ContinuousIndexedEntropyModel(
            uniform_noise.NoisyNormal, (), {}, 1, device="cpu")
    with pytest.raises(ValueError):
        ContinuousIndexedEntropyModel(
            uniform_noise.NoisyNormal, (3, 4), {}, 1, channel_axis=None,
            device="cpu")
    em = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, 4, make_scale_fn(0.5, 4.0, 4),
        coding_rank=1, compression=False, device="cpu")
    with pytest.raises(RuntimeError):
        em.compress(torch.zeros(3), torch.zeros(3))


def test_indexed_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocationScaleIndexedEntropyModel(
            uniform_noise.NoisyNormal, 4, make_scale_fn(0.5, 4.0, 4),
            coding_rank=1)
