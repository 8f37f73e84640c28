"""The soft-round family against the JAX package on the CPU:
``ops/round_ops.py`` (soft_round, soft_round_inverse,
soft_round_conditional_mean, values and gradients), every class of
``distributions/round_adapters.py`` (cdf, log_cdf, survival functions,
prob / log_prob of the noisy ones, quantile, mode, tails and quantization
offset), and ``layers/soft_round.py``.  Values within 1e-5 (2e-5 relative
for logs), gradients within 1e-4."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.distributions import helpers as jhelpers
from compression_tpu.distributions import round_adapters as jra
from compression_tpu.layers import soft_round as jlayers
from compression_tpu.ops import round_ops as jround
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import helpers as phelpers
from compression_tpu_torch.distributions import round_adapters as pra
from compression_tpu_torch.layers import soft_round as players
from compression_tpu_torch.ops import round_ops as pround

torch.set_num_threads(1)

RNG = np.random.RandomState(0)
X = np.concatenate([RNG.normal(0, 3, 200), np.arange(-4, 4.5, 0.5),
                    [1e-6, -1e-6, 0.4999, 0.5001]]).astype(np.float32)
ALPHAS = [1e-4, 0.5, 5.0, 15.0]


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("fn", ["soft_round", "soft_round_inverse",
                                "soft_round_conditional_mean"])
def test_ops_equal_jax(fn, alpha):
    x = X if fn == "soft_round" else np.asarray(
        jround.soft_round(jnp.asarray(X), alpha))
    ref = np.asarray(getattr(jround, fn)(jnp.asarray(x), alpha))
    xt = torch.tensor(x, requires_grad=True)
    mine = getattr(pround, fn)(xt, alpha)
    np.testing.assert_allclose(mine.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    (grad,) = torch.autograd.grad(mine.sum(), xt)
    ref_grad = jax.grad(lambda v: jnp.sum(getattr(jround, fn)(v, alpha)))(
        jnp.asarray(x))
    # The inverses clip r to [-.5, .5], where atanh's derivative has no
    # bound: within 1e-6 of the clip the last bit of the unclipped r, which
    # the output does not show, decides whether the clip passes the
    # gradient (derivative ~15 at alpha 5, or none).  Gradients are
    # compared away from the clip.
    shift = 0.5 if fn == "soft_round_conditional_mean" else 0.0
    base = np.floor(x - shift) + 0.5 + shift
    keep = np.isfinite(np.asarray(ref_grad))
    if fn != "soft_round":
        for out in (ref, mine.detach().numpy()):
            keep &= np.abs(np.abs(out - base) - 0.5) > 1e-6
    assert keep.sum() > 0.9 * keep.size
    np.testing.assert_allclose(grad.numpy()[keep], np.asarray(ref_grad)[keep],
                               rtol=1e-4, atol=1e-4)


def test_soft_round_alpha_gradient_equal_jax():
    x = jnp.asarray(X)
    ref = jax.grad(lambda a: jnp.sum(jround.soft_round(x, a)))(3.0)
    a = torch.tensor(3.0, requires_grad=True)
    (mine,) = torch.autograd.grad(
        pround.soft_round(torch.tensor(X), a).sum(), a)
    np.testing.assert_allclose(mine.item(), float(ref), rtol=1e-4)


def _deep_factorized_params():
    params = deep_factorized.DeepFactorized.init_params(
        (3,), generator=torch.Generator().manual_seed(2))
    return ({k: [p.detach() for p in v] for k, v in params.items()},
            {k: [jnp.asarray(p.detach().numpy()) for p in v]
             for k, v in params.items()})


def _pair(name):
    loc = np.asarray([0.3, -1.2, 2.0], np.float32)
    scale = np.asarray([0.7, 2.0, 4.5], np.float32)
    normal = dict(loc=jnp.asarray(loc), scale=jnp.asarray(scale))
    tnormal = dict(loc=torch.tensor(loc), scale=torch.tensor(scale))
    if name == "SoftRoundAdapter":
        from compression_tpu.distributions import base as jb
        from compression_tpu_torch.distributions import base as pb
        return (jra.SoftRoundAdapter(jb.Normal(**normal), 4.0),
                pra.SoftRoundAdapter(pb.Normal(**tnormal), 4.0))
    if name == "RoundAdapter":
        from compression_tpu.distributions import base as jb
        from compression_tpu_torch.distributions import base as pb
        return (jra.RoundAdapter(jb.Normal(**normal)),
                pra.RoundAdapter(pb.Normal(**tnormal)))
    if name in ("NoisyRoundedNormal", "NoisySoftRoundedNormal"):
        return getattr(jra, name)(**normal), getattr(pra, name)(**tnormal)
    pparams, jparams = _deep_factorized_params()
    return (getattr(jra, name)(params=jparams, batch_shape=(3,)),
            getattr(pra, name)(params=pparams, batch_shape=(3,)))


NAMES = ["SoftRoundAdapter", "RoundAdapter", "NoisyRoundedNormal",
         "NoisySoftRoundedNormal", "NoisyRoundedDeepFactorized",
         "NoisySoftRoundedDeepFactorized"]
METHODS = ["cdf", "log_cdf", "survival_function", "log_survival_function",
           "prob", "log_prob"]


def _call(fn):
    try:
        return np.asarray(fn())
    except NotImplementedError:
        return None


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_adapters_elementwise_equal_jax(name, method):
    jd, pd = _pair(name)
    y = np.stack([X[:60].reshape(20, 3)] * 1)[0]
    ref = _call(lambda: getattr(jd, method)(jnp.asarray(y)))
    mine = _call(lambda: getattr(pd, method)(torch.tensor(y)).numpy())
    if ref is None:
        assert mine is None
        return
    atol = 2e-5 if method.startswith("log") else 1e-5
    np.testing.assert_allclose(mine, ref, rtol=2e-5, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_adapters_tails_offset_quantile_mode(name):
    """What a table build reads, and quantile / mode where the adapter is
    invertible (NotImplementedError on both sides where it is not)."""
    jd, pd = _pair(name)
    for fn in ("lower_tail", "upper_tail"):
        np.testing.assert_allclose(
            getattr(phelpers, fn)(pd, 2 ** -8).numpy(),
            np.asarray(getattr(jhelpers, fn)(jd, 2 ** -8)), rtol=1e-5,
            atol=1e-5)
    np.testing.assert_allclose(phelpers.quantization_offset(pd).numpy(),
                               np.asarray(jhelpers.quantization_offset(jd)),
                               atol=1e-5)
    for method, args in (("quantile", (0.3,)), ("mode", ())):
        ref = _call(lambda: getattr(jd, method)(*args))
        mine = _call(lambda: getattr(pd, method)(*args).numpy())
        if ref is None:
            assert mine is None
        else:
            np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_soft_round_layers_equal_jax(inverse):
    x = jnp.asarray(X)
    ref = jlayers.SoftRound(alpha=6.0, inverse=inverse).apply({}, x)
    mine = players.SoftRound(alpha=6.0, inverse=inverse)(torch.tensor(X))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    ref = jlayers.SoftRoundConditionalMean(alpha=6.0).apply({}, x)
    mine = players.SoftRoundConditionalMean(alpha=6.0)(torch.tensor(X))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
