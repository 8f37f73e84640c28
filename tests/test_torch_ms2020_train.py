"""The port's ms2020 training path against the JAX package's, on the CPU.

``MS2020Model.forward(training=True)`` and ``make_train_step`` are fed the
JAX package's inputs: the same parameters (``params_from_jax``), the same
batch and the same noise, drawn on the JAX side as its ``__call__`` draws
it (``jax.random.split(key, num_slices + 1)``: the first key for z, then
one a slice, each through ``jax.random.uniform(k, shape, float32, -.5,
.5)``) and handed to the port as ``u = (u_z, u_0, ..., u_{n-1})``.

Three cases: tests/test_ms2020.py's tiny model, tests/test_torch_ms2020.py's
compact one as initialized, and the same compact one with its output layers
stretched as test_torch_ms2020.py stretches them (z non-zero, mu and sigma
across the scale table, latents past the tables); batch 2 of 64x64.
Tolerances: loss, bpp and mse within rtol 1e-5 of JAX's; every gradient
within 1e-4 of its largest magnitude (1e-2 in the stretched model, whose
slices lie up to ~550 scales from their means: there the two packages'
float32 log_ndtr lose their gradients' third digit, each its own way, as
tests/test_torch_train.py's INDEXED_REGIMES finds at ~130 scales; the
largest error measured there is 5.0e-3, in the scale branch); three Adam
steps (torch.optim.Adam against optax.adam(1e-3)) of the tiny and the
compact model track JAX's metrics within rtol 1e-4 at each step, and every
parameter within 2e-4 + 1e-4 |p| (a fifth of one step of size ~lr) but at
most 1e-5 of a tensor's elements (one of the tiny model's 716800-element
slice kernels at the third step), which lie within 2 x 3 lr: Adam divides
each element's step by its own gradient's size, so an element whose
gradient is float noise moves by up to lr either way.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from compression_tpu.models import ms2020 as jax_ms2020
from compression_tpu_torch.models import ms2020

torch.set_num_threads(1)

CONFIGS = {
    # tests/test_ms2020.py's tiny_model().
    "tiny": dict(lmbda=0.01, num_filters=8, latent_depth=8,
                 hyperprior_depth=4, num_slices=4, max_support_slices=2,
                 num_scales=8, scale_min=0.11, scale_max=32.0),
    # tests/test_torch_ms2020.py's compact configuration, stretched there.
    "compact": dict(num_filters=16, latent_depth=20, hyperprior_depth=8,
                    num_slices=5, max_support_slices=3, num_scales=16,
                    ha_widths=(24, 16), hs_widths=(12, 16, 20),
                    slice_widths=(16, 12)),
}
# case -> (configuration, stretched, gradient tolerance)
CASES = {"tiny": ("tiny", False, 1e-4), "compact": ("compact", False, 1e-4),
         "compact_stretched": ("compact", True, 1e-2)}
BATCH = (2, 64, 64, 3)
RTOL = 1e-5
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grad_err(got, want):
    """|got - want| over want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _stretch(params, cfg):
    """tests/test_torch_ms2020.py's stretch of the output layers."""
    import test_torch_ms2020
    return test_torch_ms2020._stretch(params, cfg)


_INITS = {}


def _init(config):
    """A jit-compiled JAX init of ``config`` (the eager one dispatches op
    by op), as numpy, a fresh copy each call."""
    if config not in _INITS:
        model = jax_ms2020.MS2020Model(**CONFIGS[config])
        _INITS[config] = _np(jax.jit(
            lambda key, x: model.init(key, x, training=False))(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    return jax.tree_util.tree_map(np.copy, _INITS[config])


class _Case:
    """A JAX model with its params and the port's model carrying them."""

    def __init__(self, name):
        self.name = name
        config, stretched, self.grad_tol = CASES[name]
        self.cfg = CONFIGS[config]
        self.x = np.random.RandomState(1).randint(0, 256, BATCH).astype(
            np.float32)
        self.jax_model = jax_ms2020.MS2020Model(**self.cfg)
        params = _init(config)
        if stretched:
            params = _stretch(params, self.cfg)
        self.params = params
        self.port_model = ms2020.MS2020Model(**self.cfg)
        self.load(params)
        y, z = self.jax_model.apply(params, jnp.asarray(self.x),
                                    method=jax_ms2020.MS2020Model.encode)
        self.shapes = (z.shape, y.shape[:-1] + (
            y.shape[-1] // self.cfg["num_slices"],))

    def load(self, params):
        self.port_model.load_state_dict(ms2020.params_from_jax(params))

    def noise(self, key):
        """The noise the JAX model draws from ``key``, as the port's u."""
        z_shape, slice_shape = self.shapes
        keys = jax.random.split(key, self.cfg["num_slices"] + 1)
        return tuple(
            torch.tensor(np.asarray(jax.random.uniform(
                k, z_shape if i == 0 else slice_shape, jnp.float32, -0.5,
                0.5))) for i, k in enumerate(keys))


_BUILT = {}


def _case(name):
    if name not in _BUILT:
        _BUILT[name] = _Case(name)
    return _BUILT[name]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module", params=["compact", "tiny"])
def unstretched(request):
    return _case(request.param)


def test_training_forward_and_gradients_match_jax(case):
    """loss, bpp and mse within rtol 1e-5 of JAX's; every gradient within
    the case's tolerance of its largest magnitude (JAX's gradients mapped
    through params_from_jax)."""
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        loss, bpp, mse = case.jax_model.apply(
            p, jnp.asarray(case.x), training=True, key=key)
        return loss, (bpp, mse)

    (loss, (bpp, mse)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(case.params)
    case.load(case.params)
    case.port_model.zero_grad()
    t_loss, t_bpp, t_mse = case.port_model(
        torch.as_tensor(case.x), training=True, u=case.noise(key))
    t_loss.backward()
    for got, want in ((t_loss, loss), (t_bpp, bpp), (t_mse, mse)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL)
    want = ms2020.params_from_jax(_np(grads))
    named = dict(case.port_model.named_parameters())
    assert set(want) == set(named)
    errors = {k: _grad_err(named[k].grad, v) for k, v in want.items()}
    assert max(errors.values()) < case.grad_tol, errors


def test_eval_forward_matches_jax(case):
    """training=False rounds both latents: loss, bpp and mse within rtol
    1e-5 of JAX's."""
    jm = case.jax_model.apply(case.params, jnp.asarray(case.x),
                              training=False)
    case.load(case.params)
    with torch.no_grad():
        tm = case.port_model(torch.as_tensor(case.x))
    for got, want in zip(tm, jm):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_three_adam_steps_track_optax(unstretched):
    """Three make_train_step steps against JAX's make_train_step with
    optax.adam(1e-3), same params, batch and noise: metrics at each step
    within rtol 1e-4; parameters within 2e-4 + 1e-4 |p| after each."""
    case = unstretched
    optimizer = optax.adam(LR)
    params = case.params
    opt_state = optimizer.init(params)
    jax_step = jax_ms2020.make_train_step(case.jax_model, optimizer)
    case.load(params)
    step = ms2020.make_train_step(
        case.port_model, torch.optim.Adam(case.port_model.parameters(),
                                          lr=LR))
    key = jax.random.PRNGKey(11)
    for i in range(3):
        key, sub = jax.random.split(key)
        u = case.noise(sub)
        params, opt_state, jm = jax_step(params, opt_state,
                                         jnp.asarray(case.x), sub)
        tm = step(case.x, u=u)
        for name in ("loss", "bpp", "mse"):
            assert tm[name].shape == () and tm[name].device.type == "cpu"
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, err_msg=f"{name}@{i}")
        want = ms2020.params_from_jax(_np(params))
        for k, v in case.port_model.state_dict().items():
            err = np.abs(v.numpy() - want[k].numpy())
            off = err > 2e-4 + 1e-4 * np.abs(want[k].numpy())
            assert off.sum() <= 1e-5 * off.size, f"{k}@{i}"
            assert err.max() <= 6 * LR, f"{k}@{i}"


def test_generator_draws_z_then_the_slices(case):
    """A generator draws z's noise first, then each slice's, in order:
    the same losses as the same draws passed in as u."""
    case.load(case.params)
    z_shape, slice_shape = case.shapes
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        by_gen = case.port_model(torch.as_tensor(case.x), training=True,
                                 generator=gen)
        again = torch.Generator().manual_seed(5)
        u = [torch.empty(z_shape).uniform_(-0.5, 0.5, generator=again)]
        u += [torch.empty(slice_shape).uniform_(-0.5, 0.5, generator=again)
              for _ in range(case.cfg["num_slices"])]
        by_u = case.port_model(torch.as_tensor(case.x), training=True,
                               u=tuple(u))
    for a, b in zip(by_gen, by_u):
        assert float(a) == float(b)


def test_training_forward_needs_noise(case):
    with pytest.raises(ValueError):
        case.port_model(torch.as_tensor(case.x), training=True)


def test_thirty_steps_lower_the_loss():
    """Mirrors tests/test_bls2017.py's test_train_step_decreases_loss on
    the port: 30 Adam steps at 1e-3 on one 32x32 image through the
    compact model (the tiny one's slice transforms are the published
    widths, 224 / 128), the noise from a generator."""
    model = ms2020.MS2020Model(**CONFIGS["compact"], seed=1)
    step = ms2020.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    gen = torch.Generator().manual_seed(2)
    x = np.random.RandomState(1).randint(0, 256, (1, 32, 32, 3)).astype(
        np.float32)
    losses = [float(step(x, generator=gen)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_codec_tables_stay_detached():
    """The codec's tables come from detached copies of the hyperprior,
    while training's prior is the parameters themselves."""
    model = ms2020.MS2020Model(**CONFIGS["tiny"])
    live = model.hyperprior()
    assert all(p is q for p, q in zip(live.base.params["matrices"],
                                      model.hyperprior_matrices))
    frozen = model.hyperprior(device="cpu")
    assert not any(p.requires_grad
                   for p in frozen.base.params["matrices"])
