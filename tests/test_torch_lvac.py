"""The port's lvac (models/lvac.py) against the JAX package's, on the CPU,
at 8 filters, batch 2 of 256-sample frames.

Both packages run JAX's init (``params_from_jax``) on the same frames and,
in training mode, the same noise (``jax.random.uniform(key, y.shape,
float32, -.5, .5)``, what JAX's entropy model draws from ``key``, handed to
the port as ``u``).  Tolerances: loss, bps and mse within 1e-5 relative;
every gradient within 1e-4 of its largest magnitude."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import lvac as jax_lvac
from compression_tpu_torch.models import lvac

torch.set_num_threads(1)

FILTERS, BATCH, FRAME = 8, 2, 256


def _setup(seed=0):
    x = next(lvac.sine_batches(BATCH, FRAME, seed))
    model = jax_lvac.LVACModel(lmbda=100.0, num_filters=FILTERS)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), training=False))
    mine = lvac.LVACModel(lmbda=100.0, num_filters=FILTERS)
    mine.load_state_dict(lvac.params_from_jax(params))
    return x, model, params, mine


def _rel(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_sine_batches_equal_jax_iterator():
    """The default data is the JAX package's: train() with steps=0 draws
    nothing, so compare with the generator JAX's train() defines."""
    rng = np.random.RandomState(3)
    t = np.arange(FRAME) / 16000.0
    f = rng.uniform(100, 2000, (BATCH, 3, 1))
    a = rng.uniform(0.1, 0.5, (BATCH, 3, 1))
    want = (a * np.sin(2 * np.pi * f * t[None, None, :])).sum(1)
    np.testing.assert_array_equal(next(lvac.sine_batches(BATCH, FRAME, 3)),
                                  want[..., None].astype(np.float32))


def test_eval_forward_matches_jax():
    x, model, params, mine = _setup()
    want = model.apply(params, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = mine(torch.tensor(x), training=False)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def test_training_forward_and_gradients_match_jax():
    x, model, params, mine = _setup(1)
    key = jax.random.PRNGKey(7)
    y_shape = (BATCH, FRAME // 16, FILTERS)
    u = np.asarray(jax.random.uniform(key, y_shape, jnp.float32, -0.5, 0.5))

    def loss_fn(p):
        loss, bps, mse = model.apply(p, jnp.asarray(x), training=True,
                                     key=key)
        return loss, (bps, mse)

    (loss, (bps, mse)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    got = mine(torch.tensor(x), training=True, u=torch.tensor(u))
    for g, w in zip(got, (loss, bps, mse)):
        assert _rel(g, w) <= 1e-5
    got[0].backward()
    want = lvac.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(mine.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((named[name].grad - w).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), name


def test_train_steps_lower_the_loss():
    """20 steps of train()'s Adam at 1e-4 on the CPU (JAX's test_lvac_trains
    takes 5): the eval-mode loss on a fixed batch falls, and train() runs
    end to end."""
    torch.manual_seed(0)
    model = lvac.LVACModel(lmbda=100.0, num_filters=FILTERS, seed=0)
    step = lvac.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-4))
    gen = torch.Generator().manual_seed(0)
    fixed = torch.tensor(next(lvac.sine_batches(BATCH, FRAME, 99)))
    with torch.no_grad():
        before = float(model(fixed, training=False)[0])
    losses = [float(step(batch, generator=gen)["loss"])
              for _, batch in zip(range(20), lvac.sine_batches(
                  BATCH, FRAME, 0))]
    with torch.no_grad():
        after = float(model(fixed, training=False)[0])
    assert all(np.isfinite(losses))
    assert after < before
    trained = lvac.train(steps=2, batch_size=BATCH, frame=FRAME,
                         num_filters=FILTERS, log_every=0, device="cpu")
    assert isinstance(trained, lvac.LVACModel)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lvac.train(steps=1)
