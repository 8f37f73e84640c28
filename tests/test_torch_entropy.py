"""The port's distributions and batched entropy model against the JAX
package, on the bls2017 prior (DeepFactorized.init_params of a 16-channel
model) and on the reference's golden_em.npz fixture."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu import distributions as jax_dist
from compression_tpu.distributions import helpers as jax_helpers
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JEM
from compression_tpu.ops import math_ops as jax_math
from compression_tpu_torch.distributions import deep_factorized, helpers
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.ops import math_ops, round_ops

torch.set_num_threads(1)

GOLDEN_EM = os.path.join(os.path.dirname(__file__), "golden",
                         "golden_em.npz")
CHANNELS = 16


def _priors(params, channels):
    jp = jax_dist.NoisyDeepFactorized(
        params={k: [jnp.asarray(v) for v in vs] for k, vs in params.items()},
        batch_shape=(channels,))
    tp = deep_factorized.NoisyDeepFactorized(
        params={k: [torch.tensor(np.asarray(v)) for v in vs]
                for k, vs in params.items()},
        batch_shape=(channels,))
    return jp, tp


@pytest.fixture(scope="module")
def priors():
    params = jax_dist.DeepFactorized.init_params(
        jax.random.PRNGKey(3), (CHANNELS,))
    return _priors(jax.tree_util.tree_map(np.asarray, params), CHANNELS)


@pytest.fixture(scope="module")
def models(priors):
    """(JAX model, port model with its own offset, port model given the JAX
    model's offset).  Cross-package code comparisons use the last: the two
    estimated offsets differ in the last ulp, so they can round a latent
    differently."""
    jp, tp = priors
    jem = JEM(prior=jp, coding_rank=3, compression=True)
    own = ContinuousBatchedEntropyModel(prior=tp, coding_rank=3,
                                        compression=True, device="cpu")
    same = ContinuousBatchedEntropyModel(
        prior=tp, coding_rank=3, compression=True,
        quantization_offset=np.asarray(jem.quantization_offset),
        device="cpu")
    return jem, own, same


def _points(seed):
    return np.random.RandomState(seed).normal(0, 8, (40, CHANNELS)).astype(
        np.float32)


# prob is a difference of two CDF values in [0, 1], so its float32 error is
# absolute, at one ulp of 1.0 (1.2e-7); log_prob inherits that error divided
# by prob.  The two frameworks' tanh/sigmoid differ in the last ulp.
@pytest.mark.parametrize("seed", range(3))
def test_noisy_deep_factorized_prob(priors, seed):
    jp, tp = priors
    x = _points(seed)
    np.testing.assert_allclose(
        tp.prob(torch.as_tensor(x)).numpy(), np.asarray(jp.prob(x)),
        rtol=1e-6, atol=1.2e-7)
    np.testing.assert_allclose(
        tp.log_prob(torch.as_tensor(x)).numpy(), np.asarray(jp.log_prob(x)),
        rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_deep_factorized_base(priors, seed):
    jp, tp = priors
    x = _points(10 + seed)
    for fn in ("log_cdf", "log_survival_function", "cdf",
               "survival_function"):
        np.testing.assert_allclose(
            getattr(tp.base, fn)(torch.as_tensor(x)).numpy(),
            np.asarray(getattr(jp.base, fn)(x)), rtol=1e-6, atol=1e-6)


def test_quantization_offset_and_tails(priors):
    jp, tp = priors
    np.testing.assert_allclose(
        helpers.quantization_offset(tp).numpy(),
        np.asarray(jax_helpers.quantization_offset(jp)), rtol=0, atol=1e-6)
    for fn in ("lower_tail", "upper_tail"):
        np.testing.assert_allclose(
            getattr(helpers, fn)(tp, 2**-8).numpy(),
            np.asarray(getattr(jax_helpers, fn)(jp, 2**-8)), rtol=1e-6)


def test_own_tables_equal_jax(models):
    jem, tem, _ = models
    np.testing.assert_array_equal(tem.cdf, np.asarray(jem.cdf))
    np.testing.assert_array_equal(tem.cdf_offset, np.asarray(jem.cdf_offset))
    np.testing.assert_allclose(
        tem.quantization_offset.numpy(),
        np.asarray(jem.quantization_offset), rtol=0, atol=1e-6)


def test_golden_em_tables():
    """golden_em.npz (the TF reference): the integer tables exactly; the
    float offset and tails to 1e-5, the JAX package's own distance from
    them (float32 Adam iterates, last ulps differ between frameworks)."""
    gold = dict(np.load(GOLDEN_EM))
    params = {
        "matrices": [gold[f"dfb__matrix_{i}"] for i in range(3)],
        "biases": [gold[f"dfb__bias_{i}"] for i in range(3)],
        "factors": [gold[f"dfb__factor_{i}"] for i in range(2)],
    }
    _, tp = _priors(params, 4)
    em = ContinuousBatchedEntropyModel(prior=tp, coding_rank=3,
                                       compression=True, device="cpu")
    np.testing.assert_array_equal(em.cdf, gold["dfb__cdf"])
    np.testing.assert_array_equal(em.cdf_offset, gold["dfb__cdf_offset"])
    np.testing.assert_allclose(em.quantization_offset.numpy(),
                               gold["dfb__qoffset"], atol=1e-5)
    np.testing.assert_allclose(helpers.lower_tail(tp, 2**-8).numpy(),
                               gold["dfb__lower_tail"], atol=1e-5)
    np.testing.assert_allclose(helpers.upper_tail(tp, 2**-8).numpy(),
                               gold["dfb__upper_tail"], atol=1e-5)
    _, bits = em(torch.as_tensor(gold["dfb__x"]))
    np.testing.assert_allclose(bits.numpy(), gold["dfb__bits"], rtol=1e-4)


def _latent(seed, scale=6.0):
    return np.random.RandomState(seed).normal(
        0, scale, (5, 1, 4, CHANNELS)).astype(np.float32)


def test_eval_call_matches_jax(models):
    jem, _, tem = models
    y = _latent(1)
    jy, jbits = jem(jnp.asarray(y), training=False)
    ty, tbits = tem(torch.as_tensor(y))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tbits.numpy(), np.asarray(jbits), rtol=1e-5)


@pytest.mark.parametrize("scale", [3.0, 40.0])
def test_compress_sidecar_matches_jax(models, scale):
    """Same latent -> identical streams and escape list (scale 40 puts
    values past the table's range on both sides)."""
    jem, _, tem = models
    y = _latent(2, scale)
    buf, lens, esc_pos, esc_val = jem.compress_sidecar(jnp.asarray(y))
    tbuf, tlens, tidx, tval = tem.compress_sidecar_device(torch.as_tensor(y))
    np.testing.assert_array_equal(tbuf.numpy(), buf)
    np.testing.assert_array_equal(tlens.numpy(), lens)
    n = y.shape[1] * y.shape[2] * y.shape[3]
    np.testing.assert_array_equal(
        tidx.numpy(), esc_pos[:, 0].astype(np.int64) * n + esc_pos[:, 1])
    np.testing.assert_array_equal(tval.numpy(), esc_val)
    if scale > 10:
        assert len(esc_val) > 0
    out, sanity = tem.decompress_sidecar_device(tbuf, tlens, (1, 4), tidx,
                                                tval)
    assert bool(sanity.all())
    np.testing.assert_array_equal(
        out.numpy(), tem.quantize(torch.as_tensor(y)).numpy())
    ref = jem.decompress_sidecar(buf, lens, (1, 4), esc_pos, esc_val)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_carried_weights(models):
    jem, own, same = models
    for w, v in zip(same.get_weights(), jem.get_weights()):
        np.testing.assert_array_equal(w, np.asarray(v))
    cdf, cdf_offset, offset = jem.get_weights()
    carried = ContinuousBatchedEntropyModel(
        prior_shape=(CHANNELS,), cdf=cdf, cdf_offset=cdf_offset,
        quantization_offset=offset, coding_rank=3, compression=True,
        device="cpu")
    y = torch.as_tensor(_latent(3, 30.0))
    for a, b in zip(carried.compress_sidecar_device(y),
                    same.compress_sidecar_device(y)):
        assert torch.equal(a, b)
    assert len(own.get_weights()) == 3


def test_round_st_matches_jax_and_passes_gradient():
    x = torch.tensor([-1.5, -0.5, 0.49, 0.5, 1.5, 2.5], requires_grad=True)
    off = torch.tensor(0.25)
    y = round_ops.round_st(x, off)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.round(x.detach().numpy() - 0.25) + np.float32(0.25))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6, np.float32))


@pytest.mark.parametrize("gradient",
                         ["identity", "identity_if_towards", "disconnected"])
def test_lower_bound_gradient_matches_jax(gradient):
    x = np.asarray([-2.0, -0.5, 0.5, 2.0], np.float32)
    g = np.asarray([1.0, -1.0, 1.0, -1.0], np.float32)
    jax_grad = jax.vjp(lambda a: jax_math.lower_bound(a, 0.0, gradient),
                       jnp.asarray(x))[1](jnp.asarray(g))[0]
    t = torch.tensor(x, requires_grad=True)
    math_ops.lower_bound(t, 0.0, gradient).backward(torch.tensor(g))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jax_grad))
