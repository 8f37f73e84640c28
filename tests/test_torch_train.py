"""The port's training path against the JAX package's, on the CPU.

``perturb_and_apply``, the two entropy models' training-mode ``__call__``
and both models' ``forward(training=True)`` / ``make_train_step`` are fed
the JAX package's inputs: the same parameters (``params_from_jax``), the
same batch and the same noise, drawn on the JAX side with the call
``perturb_and_apply`` makes (``jax.random.uniform(key, shape, float32,
-.5, .5)``; for bmshj2018 after ``jax.random.split(key)``: k1 for z, k2
for y) and handed to the port as ``u``.

Models at num_filters=16 (bmshj2018 with 16 scales), batch 2 of 64x64.
Tolerances: values within rtol 1e-5 of JAX's; ``perturb_and_apply``'s
gradients within 1e-5 of their largest magnitude, every other gradient
within 1e-4 of it (2e-3 for the indexed model's latents ~130 scales out,
INDEXED_REGIMES); three Adam steps (torch.optim.Adam
against optax.adam(1e-3)) track JAX's metrics within rtol 1e-4 at each
step, and every parameter within 2e-4 + 1e-4 |p| (Adam's steps are of
size ~lr = 1e-3, so this is a fifth of one step).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from compression_tpu import distributions as jax_dist
from compression_tpu.distributions import deep_factorized as jax_df
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JB
from compression_tpu.entropy_models.continuous_indexed import (
    LocationScaleIndexedEntropyModel as JLS)
from compression_tpu.models import bls2017 as jax_bls
from compression_tpu.models import bmshj2018 as jax_bmshj
from compression_tpu.ops import math_ops as jax_math_ops
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    LocationScaleIndexedEntropyModel)
from compression_tpu_torch.models import bls2017, bmshj2018
from compression_tpu_torch.ops import math_ops

torch.set_num_threads(1)

NUM_FILTERS = 16
NUM_SCALES = 16
BATCH = (2, 64, 64, 3)
RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _uniform(key, shape):
    """The noise JAX's perturb_and_apply draws from ``key``."""
    return np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


def _grad_err(got, want):
    """|got - want| over want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


# -- perturb_and_apply --------------------------------------------------------
def _df_params(channels, seed):
    """Deep-factorized parameters, as numpy, with factors away from zero."""
    params = _np(jax_df.DeepFactorized.init_params(
        jax.random.PRNGKey(seed), (channels,)))
    rng = np.random.RandomState(seed)
    params["factors"] = [rng.normal(0, 0.5, f.shape).astype(np.float32)
                         for f in params["factors"]]
    return params


def _jax_log_prob(x, params):
    prior = jax_dist.UniformNoiseAdapter(
        jax_df.DeepFactorized(params=params, batch_shape=(x.shape[-1],)))
    return prior.log_prob(x)


def _port_log_prob(x, params):
    return deep_factorized.NoisyDeepFactorized(
        params=params, batch_shape=(x.shape[-1],)).log_prob(x)


@pytest.mark.parametrize("expected_grads", [False, True])
def test_perturb_and_apply_matches_jax(expected_grads):
    """Values, the gradient to x and to the prior's parameters (passed as
    an argument), and the identity gradient of x + u, within rtol 1e-5."""
    rng = np.random.RandomState(0)
    x = (rng.normal(0, 3, (40, 5))).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    params = _df_params(5, 1)

    def jax_loss(x, p):
        y, xpu = jax_math_ops.perturb_and_apply(
            _jax_log_prob, x, p, u=u, expected_grads=expected_grads)
        return jnp.sum(w * y) + jnp.sum(w * w * xpu), (y, xpu)

    (_, (jy, jxpu)), (jgx, jgp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(x, params)

    tx = _t(x).requires_grad_()
    tp = {k: [_t(a).requires_grad_() for a in v] for k, v in params.items()}
    y, xpu = math_ops.perturb_and_apply(
        _port_log_prob, tx, tp, u=_t(u), expected_grads=expected_grads)
    (torch.sum(_t(w) * y) + torch.sum(_t(w * w) * xpu)).backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(xpu.detach().numpy(), jxpu)
    assert _grad_err(tx.grad, jgx) < RTOL
    for key in params:
        for got, want in zip(tp[key], jgp[key]):
            assert _grad_err(got.grad, want) < RTOL, key


def test_perturb_and_apply_expected_grad_is_the_difference():
    """With expected_grads the gradient to x is f(x + .5) - f(x - .5),
    whatever the noise; without it, f'(x + u)."""
    x = torch.linspace(-3, 3, 13, requires_grad=True)
    u = torch.full_like(x, 0.25)
    y, _ = math_ops.perturb_and_apply(torch.sin, x, u=u, expected_grads=True)
    y.sum().backward()
    torch.testing.assert_close(
        x.grad, torch.sin(x.detach() + .5) - torch.sin(x.detach() - .5))
    x.grad = None
    y, _ = math_ops.perturb_and_apply(torch.sin, x, u=u, expected_grads=False)
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.cos(x.detach() + u))


def test_perturb_and_apply_noise_sources():
    """Exactly one noise source; a generator draws U(-.5, .5) on x's
    device and nowhere else."""
    x = torch.zeros(1000)
    with pytest.raises(ValueError):
        math_ops.perturb_and_apply(torch.sin, x)
    with pytest.raises(ValueError):
        math_ops.perturb_and_apply(torch.sin, x, u=x, x_plus_u=x)
    gen = torch.Generator().manual_seed(3)
    with pytest.raises(ValueError):
        math_ops.perturb_and_apply(torch.sin, x, u=x, generator=gen,
                                   x_plus_u=x)
    _, xpu = math_ops.perturb_and_apply(torch.sin, x, generator=gen)
    assert float(xpu.min()) >= -0.5 and float(xpu.max()) < 0.5
    again = torch.Generator().manual_seed(3)
    _, xpu2 = math_ops.perturb_and_apply(torch.sin, x, generator=again)
    torch.testing.assert_close(xpu, xpu2)
    # A generator on another device than the tensor raises; nothing is
    # drawn on the CPU and copied.
    with pytest.raises(ValueError, match="drawn where the tensor lies"):
        math_ops.perturb_and_apply(
            torch.sin, torch.zeros(4, device="meta"), generator=gen)


# -- the entropy models' training __call__ ----------------------------------
@pytest.mark.parametrize("expected_grads", [False, True])
def test_batched_em_training_call_matches_jax(expected_grads):
    """ContinuousBatchedEntropyModel(training=True) with the same u: the
    perturbed bottleneck exactly, bits within rtol 1e-5, the gradient to
    the bottleneck within 1e-4 of its largest magnitude (the expected
    gradient is a difference of two log-probabilities in float32)."""
    rng = np.random.RandomState(2)
    params = _df_params(NUM_FILTERS, 4)
    x = rng.normal(0, 4, (2, 3, 5, NUM_FILTERS)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    jem = JB(jax_dist.UniformNoiseAdapter(jax_df.DeepFactorized(
        params=params, batch_shape=(NUM_FILTERS,))), coding_rank=3,
        compression=False, offset_heuristic=False,
        expected_grads=expected_grads)
    (jpert, jbits), vjp = jax.vjp(
        lambda b: jem(b, training=True, u=u), jnp.asarray(x))
    (jgx,) = vjp((jnp.ones_like(jpert), jnp.ones_like(jbits)))

    tem = ContinuousBatchedEntropyModel(
        prior=deep_factorized.NoisyDeepFactorized(
            params={k: [_t(a) for a in v] for k, v in params.items()},
            batch_shape=(NUM_FILTERS,)),
        coding_rank=3, compression=False, offset_heuristic=False,
        expected_grads=expected_grads, device="cpu")
    assert tem.expected_grads == expected_grads
    tx = _t(x).requires_grad_()
    pert, bits = tem(tx, training=True, u=_t(u))
    (pert.sum() + bits.sum()).backward()
    np.testing.assert_array_equal(pert.detach().numpy(), jpert)
    np.testing.assert_allclose(bits.detach().numpy(), jbits, rtol=RTOL)
    assert _grad_err(tx.grad, jgx) < GRAD_TOL
    with pytest.raises(ValueError):
        tem(tx, training=True)


# The indexed model's data: latents within a few scales of zero, what a
# trained model gives it; and latents up to ~130 scales out, where the two
# packages' float32 log_ndtr (jax.scipy.special, torch.special) lose their
# gradient's fourth digit, each its own way.
INDEXED_REGIMES = {"within_scales": 1e-4, "deep_tail": 2e-3}


@pytest.mark.parametrize("regime", sorted(INDEXED_REGIMES))
@pytest.mark.parametrize("with_loc", [False, True])
@pytest.mark.parametrize("expected_grads", [False, True])
def test_indexed_em_training_call_matches_jax(expected_grads, with_loc,
                                              regime):
    """LocationScaleIndexedEntropyModel(training=True) with the same u, with
    and without loc: bits within rtol 1e-5; the gradient to the
    bottleneck, to the (float) scale indexes and to loc within 1e-4 of
    their largest magnitude (2e-3 deep in the tail, INDEXED_REGIMES): the
    indexes' gradient comes through the prior they pick."""
    rng = np.random.RandomState(5)
    shape = (2, 4, 4, NUM_FILTERS)
    idx = rng.uniform(-1, NUM_SCALES + 1, shape).astype(np.float32)
    if regime == "deep_tail":
        x = rng.normal(0, 6, shape).astype(np.float32)
    else:
        scale = np.exp(np.interp(np.clip(idx, 0, NUM_SCALES - 1),
                                 [0, NUM_SCALES - 1],
                                 [np.log(0.11), np.log(256.0)]))
        x = (rng.normal(0, 2, shape) * scale).astype(np.float32)
    loc = rng.normal(0, 2, shape).astype(np.float32) if with_loc else None
    if loc is not None:
        x = x + loc  # the model codes x - loc
    u = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    jem = JLS(jax_dist.NoisyNormal, NUM_SCALES,
              jax_bmshj.make_scale_fn(0.11, 256.0, NUM_SCALES), coding_rank=3,
              compression=False, expected_grads=expected_grads)

    def jax_fn(b, i, l):
        return jem(b, i, loc=l, training=True, u=u)

    (jpert, jbits), vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(idx),
                                  None if loc is None else jnp.asarray(loc))
    jg = vjp((jnp.ones_like(jpert), jnp.ones_like(jbits)))

    tem = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, NUM_SCALES,
        bmshj2018.make_scale_fn(0.11, 256.0, NUM_SCALES), coding_rank=3,
        compression=False, expected_grads=expected_grads, device="cpu")
    tx, ti = _t(x).requires_grad_(), _t(idx).requires_grad_()
    tl = None if loc is None else _t(loc).requires_grad_()
    pert, bits = tem(tx, ti, loc=tl, training=True, u=_t(u))
    (pert.sum() + bits.sum()).backward()
    np.testing.assert_allclose(pert.detach().numpy(), jpert, rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(bits.detach().numpy(), jbits, rtol=RTOL)
    tol = INDEXED_REGIMES[regime]
    assert _grad_err(tx.grad, jg[0]) < tol
    assert _grad_err(ti.grad, jg[1]) < tol
    if with_loc:
        assert _grad_err(tl.grad, jg[2]) < tol


# -- the models ---------------------------------------------------------------
class _Case:
    """A JAX model with its params and the port's model carrying them."""

    def __init__(self, name):
        self.name = name
        self.x = np.random.RandomState(1).randint(0, 256, BATCH).astype(
            np.float32)
        if name == "bls2017":
            self.jax_model = jax_bls.BLS2017Model(num_filters=NUM_FILTERS)
            self.jax_module = jax_bls
            self.port = bls2017
            self.port_model = bls2017.BLS2017Model(num_filters=NUM_FILTERS)
        else:
            self.jax_model = jax_bmshj.BMSHJ2018Model(
                num_filters=NUM_FILTERS, num_scales=NUM_SCALES)
            self.jax_module = jax_bmshj
            self.port = bmshj2018
            self.port_model = bmshj2018.BMSHJ2018Model(
                num_filters=NUM_FILTERS, num_scales=NUM_SCALES)
        self.params = self.jax_model.init(
            jax.random.PRNGKey(0), jnp.asarray(self.x), training=False)
        self.load(self.params)

    def load(self, params):
        self.port_model.load_state_dict(self.port.params_from_jax(
            _np(params)))

    def noise(self, key):
        """The noise the JAX model draws from ``key``, as the port's u."""
        encode = self.jax_module.BLS2017Model.encode \
            if self.name == "bls2017" else \
            self.jax_module.BMSHJ2018Model.encode
        out = self.jax_model.apply(self.params, jnp.asarray(self.x),
                                   method=encode)
        if self.name == "bls2017":
            return _t(_uniform(key, out.shape))
        y, z = out
        k1, k2 = jax.random.split(key)
        return _t(_uniform(k1, z.shape)), _t(_uniform(k2, y.shape))


@pytest.fixture(scope="module", params=["bls2017", "bmshj2018"])
def case(request):
    return _Case(request.param)


def test_training_forward_and_gradients_match_jax(case):
    """loss, bpp and mse within rtol 1e-5 of JAX's; every gradient within
    1e-4 of its largest magnitude (JAX's gradients mapped through
    params_from_jax)."""
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
    want = case.port.params_from_jax(_np(grads))
    named = dict(case.port_model.named_parameters())
    assert set(want) == set(named)
    errors = {k: _grad_err(named[k].grad, v) for k, v in want.items()}
    assert max(errors.values()) < GRAD_TOL, errors


def test_three_adam_steps_track_optax(case):
    """Three make_train_step steps against JAX's make_train_step with
    optax.adam(1e-3), same params, batch and noise: metrics at each step
    within rtol 1e-4; parameters within 2e-4 + 1e-4 |p| after each."""
    optimizer = optax.adam(LR)
    params = case.params
    opt_state = optimizer.init(params)
    jax_step = case.jax_module.make_train_step(case.jax_model, optimizer)
    case.load(params)
    step = case.port.make_train_step(
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
        want = case.port.params_from_jax(_np(params))
        for k, v in case.port_model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=2e-4,
                                       err_msg=f"{k}@{i}")
    case.params = params  # later tests need no particular params


def test_thirty_steps_lower_the_loss(case):
    """Mirrors tests/test_bls2017.py's test_train_step_decreases_loss on
    the port: 30 Adam steps at 1e-3 on one batch, the noise from a
    generator."""
    model = case.port.BLS2017Model(num_filters=NUM_FILTERS) \
        if case.name == "bls2017" else case.port.BMSHJ2018Model(
            num_filters=NUM_FILTERS, num_scales=NUM_SCALES)
    step = case.port.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    gen = torch.Generator().manual_seed(2)
    x = np.random.RandomState(1).randint(0, 256, BATCH).astype(np.float32)
    losses = [float(step(x, generator=gen)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_training_forward_needs_noise(case):
    with pytest.raises(ValueError):
        case.port_model(torch.as_tensor(case.x), training=True)


def test_train_runs_on_the_cpu_and_needs_cuda_by_default(capsys):
    model = bls2017.train(num_filters=8, batch_size=1, patchsize=32,
                          steps=2, log_every=1, device="cpu")
    assert isinstance(model, bls2017.BLS2017Model)
    assert next(model.parameters()).device.type == "cpu"
    logged = capsys.readouterr().out.strip().splitlines()
    assert len(logged) == 2 and "'loss'" in logged[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bls2017.train(steps=1)
