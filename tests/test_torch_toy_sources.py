"""The port's toy-source harness (models/toy_sources.py) against the JAX
package's, on the CPU, at small widths (hidden 16, batches of 64).

Both packages run JAX's init (``params_from_jax``) on the same samples and
the same noise (JAX's ``jax.random.split(key)``: k1 for the rate, k2 for
the distortion, each ``jax.random.uniform(k, y.shape, float32, -.5, .5)``,
handed to the port as ``u``).  Tolerances: samplers within 1e-6; losses
within 1e-5 relative; gradients within 1e-4 of their largest magnitude
(the scalar logit_alpha's, a sum that mostly cancels, of the model's
largest gradient); the codebook's indexes exactly and its entries within
1e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import toy_sources as jax_ts
from compression_tpu_torch.models import toy_sources as ts

torch.set_num_threads(1)


def _rel(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else got
    return abs(got - float(want)) / max(abs(float(want)), 1e-30)


# -- sources -------------------------------------------------------------------
# JAX's samplers take the key first; the port's take no key.
SOURCES = {
    "ramp": (lambda m, t, *key: m.ramp_sample(*key, 8, t, phase=0.37)),
    "sinusoid": (lambda m, t, *key: m.sinusoid_sample(*key, 8, t,
                                                      phase=0.81)),
    "sawbridge": (lambda m, t, *key: m.sawbridge_sample(
        *key, 8, t, phase=np.linspace(0, 1, 8, dtype=np.float32)[:, None],
        drop=0.4)),
    "sawbridge_order2": (lambda m, t, *key: m.sawbridge_sample(
        *key, 8, t, phase=0.2, drop=0.65, order=2)),
    "sawbridge_nonstationary": (lambda m, t, *key: m.sawbridge_sample(
        *key, 8, t, drop=0.5, stationary=False)),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_samplers_with_fixed_values_match_jax(name):
    t = np.linspace(0, 1, 33, dtype=np.float32)
    got = SOURCES[name](ts, torch.tensor(t))
    want = SOURCES[name](jax_ts, jnp.asarray(t), jax.random.PRNGKey(0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_random_samplers():
    gen = torch.Generator().manual_seed(0)
    t = torch.linspace(0, 1, 16)
    assert ts.ramp_sample(8, t, generator=gen).abs().max() <= 0.5
    assert ts.sinusoid_sample(8, t, generator=gen).abs().max() <= 1.0
    assert torch.isfinite(ts.sawbridge_sample(4, t, order=2,
                                              generator=gen)).all()
    x = ts.sphere_sample(100, order=3, generator=gen)
    np.testing.assert_allclose(x.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    shell = ts.sphere_sample(100, order=2, width=0.5, generator=gen)
    # As in JAX, the radius is divided by U(1 - w/2, 1 + w/2).
    norms = shell.norm(dim=-1)
    assert bool(((norms >= 1 / 1.25 - 1e-6) & (norms <= 1 / 0.75 + 1e-6)
                 ).all())


def test_sphere_sample_defaults_to_the_card():
    # With a generator the samples follow its device; without one they go
    # to the card, and a CPU call must ask for it.
    assert ts.sphere_sample(4, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert ts.sphere_sample(4).is_cuda
        cuda_gen = torch.Generator(device="cuda").manual_seed(0)
        assert ts.sphere_sample(4, generator=cuda_gen).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.sphere_sample(4)


# -- NTC -----------------------------------------------------------------------
CONFIGS = {
    "default": dict(),
    "hard_guess_offset": dict(soft_round=(False, False), guess_offset=True,
                              dither=(True, False, False, False)),
    "soft_test": dict(dither=(True, False, True, True),
                      soft_round=(True, True), distortion_loss="mse"),
}
NTC_CASES = [(p, c) for p in ("deep", "gsm-2", "lmm-2") for c in CONFIGS]


def _ntc_pair(prior_type, config, seed=0):
    kw = dict(ndim_source=2, ndim_latent=2, lmbda=10.0,
              prior_type=prior_type, hidden=16, **CONFIGS[config])
    jmodel = jax_ts.NTCModel(**kw)
    x = np.asarray(jax_ts.sphere_sample(jax.random.PRNGKey(seed), 64,
                                        width=0.5))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed + 1), jnp.asarray(x), training=False,
        key=jax.random.PRNGKey(seed + 2)))
    mine = ts.NTCModel(**kw)
    mine.load_state_dict(ts.params_from_jax(params))
    return x, jmodel, params, mine


def _noise(key, shape):
    k1, k2 = jax.random.split(key)
    return tuple(torch.tensor(np.asarray(jax.random.uniform(
        k, shape, jnp.float32, -0.5, 0.5))) for k in (k1, k2))


@pytest.mark.parametrize("prior_type,config", NTC_CASES,
                         ids=[f"{p}-{c}" for p, c in NTC_CASES])
def test_ntc_losses_and_gradients_match_jax(prior_type, config):
    x, jmodel, params, mine = _ntc_pair(prior_type, config)
    key = jax.random.PRNGKey(5)
    u = _noise(key, x.shape[:-1] + (2,))
    for training in (True, False):
        want = jmodel.apply(params, jnp.asarray(x), training=training,
                            key=key)
        got = mine(torch.tensor(x), training=training, u=u)
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5, (training, g, w)

    grads = jax.grad(lambda p: jmodel.apply(
        p, jnp.asarray(x), training=True, key=key)[0])(params)
    mine.zero_grad()
    mine(torch.tensor(x), training=True, u=u)[0].backward()
    want = ts.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(mine.named_parameters())
    assert set(want) == set(named)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        # A parameter off the path (alpha without soft rounding) has no
        # gradient in torch and a zero one in JAX.
        g = named[name].grad
        g = torch.zeros_like(w) if g is None else g
        err = float((g - w).abs().max())
        # logit_alpha's gradient is one sum of terms that mostly cancel
        # (2e-6 to 4e-4 here): it is held to the model's largest gradient.
        scale = largest if name == "logit_alpha" else float(w.abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), name


def test_mixture_priors_have_a_trainable_loc():
    """JAX's "m" in prior_type[:4] holds for all four mixture kinds."""
    for kind in ("gsm-3", "gmm-3", "lsm-3", "lmm-3"):
        names = dict(ts.NTCModel(1, 1, prior_type=kind,
                                 hidden=4).named_parameters())
        assert names["loc"].shape == (1, 3)
        jax_params = jax_ts.NTCModel(1, 1, prior_type=kind, hidden=4).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 1)), training=False)
        assert "loc" in jax_params["params"]
    with pytest.raises(ValueError):
        ts.NTCModel(1, 1, prior_type="cauchy")


@pytest.mark.parametrize("prior_type", ["deep", "gmm-2"])
def test_quantize_codebook_matches_jax(prior_type):
    kw = dict(ndim_source=1, ndim_latent=1, lmbda=30.0, hidden=8,
              prior_type=prior_type)
    jmodel = jax_ts.NTCModel(**kw)
    x = np.linspace(-1, 1, 64, dtype=np.float32)[:, None]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), training=False))
    # Spread the latents over several codewords.
    params["params"]["analysis"]["out"]["kernel"] = 40.0 * params[
        "params"]["analysis"]["out"]["kernel"]
    want = jmodel.apply(params, jnp.asarray(x),
                        method=jax_ts.NTCModel.quantize_codebook)
    mine = ts.NTCModel(**kw)
    mine.load_state_dict(ts.params_from_jax(params))
    got = mine.quantize_codebook(torch.tensor(x))
    assert len(want[0]) > 3
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert got[2].dtype == torch.int32
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


# -- VECVQ ---------------------------------------------------------------------
def test_vecvq_matches_jax():
    jmodel = jax_ts.VECVQModel(ndim_source=2, codebook_size=8, lmbda=20.0,
                               logit_scale=3.0)
    x = np.asarray(jax_ts.sphere_sample(jax.random.PRNGKey(2), 64))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.asarray(x), training=False))
    mine = ts.VECVQModel(ndim_source=2, codebook_size=8, lmbda=20.0,
                         logit_scale=3.0)
    mine.load_state_dict(ts.params_from_jax(params))
    want = jmodel.apply(params, jnp.asarray(x))
    got = mine(torch.tensor(x))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    codebook, rates, indexes = mine.quantize(torch.tensor(x))
    jcodebook, jrates, jindexes = jmodel.apply(
        params, jnp.asarray(x), method=jax_ts.VECVQModel.quantize)
    np.testing.assert_array_equal(indexes.numpy(), np.asarray(jindexes))
    np.testing.assert_allclose(rates.detach().numpy(), np.asarray(jrates),
                               rtol=1e-5)
    np.testing.assert_array_equal(codebook.detach().numpy(),
                                  np.asarray(jcodebook))


# -- training ------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["deep", "gmm-2", "vecvq"])
def test_train_ntc_lowers_the_loss(kind):
    t = torch.linspace(0, 1, 2)
    if kind == "vecvq":
        model = ts.VECVQModel(ndim_source=2, codebook_size=8, lmbda=20.0)
    else:
        model = ts.NTCModel(2, 2, lmbda=10.0, prior_type=kind, hidden=16)

    def sample(n, generator):
        return ts.sawbridge_sample(n, t, generator=generator)

    fixed = sample(256, torch.Generator().manual_seed(9))
    with torch.no_grad():
        before = float(model(fixed, training=False)[0])
    model, metrics = ts.train_ntc(sample, model, steps=60, batch_size=64,
                                  device="cpu")
    with torch.no_grad():
        after = float(model(fixed, training=False)[0])
    assert np.isfinite(float(metrics["loss"]))
    assert after < before


def test_train_ntc_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.train_ntc(lambda n, g: torch.zeros(n, 2),
                     ts.VECVQModel(2, 4), steps=1)
