"""The port's distributions -- Normal, Logistic, Laplace, Categorical,
MixtureSameFamily and their Noisy* counterparts -- against the JAX
package's on seeded numpy inputs, far into the tails (Normal's CDF there
is the cephes formula JAX computes; torch.special.ndtr in float32 loses
the left tail): log_prob, prob, cdf, log_cdf, survival
functions, quantile, mean, the tails and quantization offsets the table
build takes (helpers.lower_tail / upper_tail / quantization_offset, the
mixtures' through estimate_tails), and the entropy models'
laplace_tail_mass likelihood.  Float results agree within the stated
tolerances; tails and offsets within 1e-5."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from compression_tpu.distributions import base as jbase
from compression_tpu.distributions import helpers as jhelpers
from compression_tpu.distributions import uniform_noise as jnoise
from compression_tpu_torch.distributions import base as pbase
from compression_tpu_torch.distributions import helpers as phelpers
from compression_tpu_torch.distributions import uniform_noise as pnoise

torch.set_num_threads(1)

RNG = np.random.RandomState(0)
LOC = RNG.normal(0, 2, (3, 4)).astype(np.float32)
SCALE = RNG.uniform(0.2, 5, (3, 4)).astype(np.float32)
X = RNG.normal(0, 6, (5, 3, 4)).astype(np.float32)
# Mixtures: 3 components on the last axis.
MLOC = RNG.normal(0, 3, (4, 3)).astype(np.float32)
MSCALE = RNG.uniform(0.3, 4, (4, 3)).astype(np.float32)
MWEIGHT = RNG.dirichlet(np.ones(3), 4).astype(np.float32)
MX = RNG.normal(0, 6, (6, 4)).astype(np.float32)


def _pair(name):
    """(JAX distribution, port distribution, inputs) of one case."""
    loc, scale = dict(loc=LOC, scale=SCALE), dict(loc=torch.tensor(LOC),
                                                 scale=torch.tensor(SCALE))
    mix = dict(loc=MLOC, scale=MSCALE, weight=MWEIGHT)
    tmix = {k: torch.tensor(v) for k, v in mix.items()}
    if name in ("Logistic", "Laplace", "Normal"):
        return getattr(jbase, name)(**loc), getattr(pbase, name)(**scale), X
    if name in ("NoisyLogistic", "NoisyLaplace", "NoisyNormal"):
        return (getattr(jnoise, name)(**loc), getattr(pnoise, name)(**scale),
                X)
    if name in ("NoisyNormalMixture", "NoisyLogisticMixture"):
        return getattr(jnoise, name)(**mix), getattr(pnoise, name)(**tmix), MX
    comp = "Normal" if name == "NormalMixture" else "Logistic"
    return (jbase.MixtureSameFamily(
                jbase.Categorical(probs=MWEIGHT),
                getattr(jbase, comp)(loc=MLOC, scale=MSCALE)),
            pbase.MixtureSameFamily(
                pbase.Categorical(probs=torch.tensor(MWEIGHT)),
                getattr(pbase, comp)(loc=torch.tensor(MLOC),
                                     scale=torch.tensor(MSCALE))), MX)


NAMES = ["Normal", "NoisyNormal", "Logistic", "Laplace", "NoisyLogistic",
         "NoisyLaplace",
         "NormalMixture", "LogisticMixture", "NoisyNormalMixture",
         "NoisyLogisticMixture"]
METHODS = ["log_prob", "prob", "log_cdf", "cdf", "log_survival_function",
           "survival_function"]


def _call(dist, method, x):
    try:
        return np.asarray(getattr(dist, method)(x))
    except NotImplementedError:
        return None


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_elementwise_equal_jax(name, method):
    """Within 2e-5 relative, 1e-6 absolute (log values: 2e-5 absolute)."""
    jd, pd, x = _pair(name)
    ref = _call(jd, method, jnp.asarray(x))
    mine = _call(pd, method, torch.tensor(x))
    if ref is None:
        assert mine is None
        return
    assert mine.shape == ref.shape and mine.dtype == np.float32
    atol = 2e-5 if method.startswith("log") else 1e-6
    np.testing.assert_allclose(mine, ref, rtol=2e-5, atol=atol)


@pytest.mark.parametrize("name", ["Logistic", "Laplace"])
def test_quantile_mean_mode(name):
    jd, pd, _ = _pair(name)
    p = RNG.uniform(1e-4, 1 - 1e-4, (3, 4)).astype(np.float32)
    np.testing.assert_allclose(pd.quantile(torch.tensor(p)).numpy(),
                               np.asarray(jd.quantile(jnp.asarray(p))),
                               rtol=1e-5, atol=1e-5)
    for method in ("mean", "mode"):
        np.testing.assert_array_equal(getattr(pd, method)().numpy(),
                                      np.asarray(getattr(jd, method)()))
    assert pd.batch_shape == tuple(jd.batch_shape) == (3, 4)


@pytest.mark.parametrize("name", ["NormalMixture", "LogisticMixture"])
def test_mixture_mean_and_shape(name):
    jd, pd, _ = _pair(name)
    assert pd.batch_shape == tuple(jd.batch_shape) == (4,)
    np.testing.assert_allclose(pd.mean().numpy(), np.asarray(jd.mean()),
                               rtol=1e-6, atol=1e-6)


def test_categorical_logits_and_probs():
    logits = RNG.normal(0, 2, (4, 3)).astype(np.float32)
    for kw in ({"logits": logits}, {"probs": MWEIGHT}):
        np.testing.assert_allclose(
            pbase.Categorical(**{k: torch.tensor(v) for k, v in kw.items()})
            .log_probs().numpy(),
            np.asarray(jbase.Categorical(**kw).log_probs()), atol=1e-6)
    with pytest.raises(ValueError):
        pbase.Categorical()
    with pytest.raises(ValueError):
        pbase.Categorical(probs=torch.tensor(MWEIGHT),
                          logits=torch.tensor(logits))


@pytest.mark.parametrize("tail_mass", [2 ** -8, 1e-3])
@pytest.mark.parametrize("name", NAMES)
def test_tails_and_offset_equal_jax(name, tail_mass):
    """What the table build reads: lower / upper tails (the mixtures'
    by estimate_tails) and the quantization offset, within 1e-5."""
    jd, pd, _ = _pair(name)
    for fn in ("lower_tail", "upper_tail"):
        np.testing.assert_allclose(
            getattr(phelpers, fn)(pd, tail_mass).numpy(),
            np.asarray(getattr(jhelpers, fn)(jd, tail_mass)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(phelpers.quantization_offset(pd).numpy(),
                               np.asarray(jhelpers.quantization_offset(jd)),
                               atol=1e-5)


@pytest.mark.parametrize("ltm", [0.0, 1e-3, 0.2])
def test_laplace_tail_mass_log_prob(ltm):
    """``_log_prob`` with ``laplace_tail_mass``: the prior mixed with a
    unit NoisyLaplace, its log floored where the mixture's probability
    underflows (x far in the tails), against the JAX base class."""
    from compression_tpu.entropy_models.continuous_base import (
        ContinuousEntropyModelBase as JBase)
    from compression_tpu_torch.entropy_models.continuous_base import (
        ContinuousEntropyModelBase as PBase)
    x = np.concatenate([X.reshape(-1), [-400.0, 90.0, 2e3]]).astype(
        np.float32)
    jem = JBase(coding_rank=1, laplace_tail_mass=ltm)
    pem = PBase(coding_rank=1, laplace_tail_mass=ltm, device="cpu")
    ref = np.asarray(jem._log_prob(
        jnoise.NoisyNormal(loc=0.5, scale=1.5), jnp.asarray(x)))
    mine = pem._log_prob(pnoise.NoisyNormal(loc=0.5, scale=1.5),
                         torch.tensor(x)).numpy()
    assert np.all(np.isfinite(mine)) == np.all(np.isfinite(ref))
    np.testing.assert_allclose(mine, ref, rtol=2e-5, atol=2e-5)
    assert pem.laplace_tail_mass == ltm


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_laplace_tail_mass_in_continuous_models(kind, training):
    """The continuous batched and location-scale indexed models pass
    ``laplace_tail_mass`` to their bits (eval and training with shared
    noise) as the JAX package's do: within 2e-5 relative.  In eval mode
    the batched model without tables rounds about its prior's
    quantization offset (the offset heuristic), as JAX's does."""
    from compression_tpu.entropy_models import (
        ContinuousBatchedEntropyModel as JB,
        LocationScaleIndexedEntropyModel as JI)
    from compression_tpu_torch.entropy_models.continuous_batched import (
        ContinuousBatchedEntropyModel as PB)
    from compression_tpu_torch.entropy_models.continuous_indexed import (
        LocationScaleIndexedEntropyModel as PI)
    x = np.concatenate([X.reshape(5, 12), np.full((5, 1), 60.0)],
                       1).astype(np.float32)
    u = np.random.RandomState(3).uniform(-0.5, 0.5, x.shape).astype(
        np.float32)
    kw = dict(training=training)
    if kind == "batched":
        jem = JB(jnoise.NoisyLogistic(loc=0.2, scale=1.5), coding_rank=1,
                 laplace_tail_mass=1e-3)
        pem = PB(pnoise.NoisyLogistic(loc=0.2, scale=1.5), coding_rank=1,
                 laplace_tail_mass=1e-3, device="cpu")
        ref = jem(jnp.asarray(x), u=jnp.asarray(u), **kw)[1]
        mine = pem(torch.tensor(x), u=torch.tensor(u), **kw)[1]
    else:
        idx = np.random.RandomState(4).uniform(0, 7, x.shape).astype(
            np.float32)
        jem = JI(jnoise.NoisyNormal, 8, lambda i: jnp.exp(0.5 * i - 1),
                 coding_rank=1, laplace_tail_mass=1e-3)
        pem = PI(pnoise.NoisyNormal, 8, lambda i: torch.exp(0.5 * i - 1),
                 coding_rank=1, laplace_tail_mass=1e-3, device="cpu")
        ref = jem(jnp.asarray(x), jnp.asarray(idx), u=jnp.asarray(u),
                  **kw)[1]
        mine = pem(torch.tensor(x), torch.tensor(idx), u=torch.tensor(u),
                   **kw)[1]
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=2e-5)
