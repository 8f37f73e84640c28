"""The port's HiFiC training half against the JAX package's, on the CPU.

``SpectralNorm`` against flax's ``nn.SpectralNorm(nn.Conv)`` (output, the
stored ``u`` and ``sigma``, the gradient through ``sigma``) with
``update_stats`` both ways; the tests' tiny ``Discriminator``
(tests/test_hific.py: base 4, two layers, two downsamplings) on JAX's
variables (``disc_params_from_jax``): logits, stored state and every
gradient; the ``hific``-width discriminator's variable names and shapes;
``HiFiCModel.forward(training=True)`` at tests/test_torch_hific.py's tiny
and compact (stretched) configurations, the noise drawn on the JAX side as
its forward draws it (z from ``jax.random.split(key, 1)[0]``, y from
``key``, each ``jax.random.uniform(k, shape, float32, -.5, .5)``) and
handed over as ``u = (u_z, u_y)``; ``rd_loss`` on both sides of the target
and of ``schedule_steps``; three alternating g / d steps (torch Adam
against ``optax.adam(1e-4)``, LPIPS on, both packages loading one npz of
random LPIPS weights through ``lpips_weights_path``); ``train`` on the CPU
with and without the GAN.

Tolerances: outputs and gradients within 1e-5 of the reference's largest
magnitude (2e-5 for the stretched compact model's float path, the
serving tests' tolerance); nbpp and qbpp within rtol 1e-5; rd_loss within
rtol 1e-6; in the steps the metrics within rtol 1e-4 at each step, every
parameter within a fifth of a step (0.2 lr) + 1e-4 |p| but at most 1e-5
of a tensor's elements (tests/test_torch_ms2020_train.py's rule: Adam
divides each element's step by its own gradient's size, so an element
whose gradient is float noise moves by up to lr either way), all within
6 lr, and the discriminator's ``u`` and ``sigma`` within 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

from compression_tpu.models import hific as jax_hific
from compression_tpu_torch.models import hific, lpips
# tests/test_torch_hific.py's configurations; its compact one stretched.
from test_torch_hific import CONFIGS, _stretch

torch.set_num_threads(1)

TINY_DISC = dict(num_filters_base=4, num_layers=2, num_down=2)
LR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(mine, ref, tol):
    """Within ``tol`` of ``ref``'s largest magnitude (at least 1e-30)."""
    ref = np.asarray(ref)
    mine = np.asarray(mine.detach() if isinstance(mine, torch.Tensor)
                      else mine)
    assert mine.shape == ref.shape
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(mine - ref).max(initial=0.0)) / scale
    assert err <= tol, err


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


# -- SpectralNorm ---------------------------------------------------------
@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 2)])
@pytest.mark.parametrize("update_stats", [True, False])
def test_spectral_norm_matches_flax(kernel, stride, update_stats):
    """hific.SpectralNorm on hific.Conv against nn.SpectralNorm(nn.Conv):
    the output, the stored u and sigma (unchanged without update_stats,
    though the power step runs), and the gradient of a weighted sum of
    the output in the kernel, the bias and the input."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, 8, 10, 5)).astype(np.float32)
    weight = rng.normal(0, 1, (2, 8 // stride, 10 // stride, 6)).astype(
        np.float32)
    ref = fnn.SpectralNorm(fnn.Conv(6, (kernel, kernel),
                                    strides=(stride, stride),
                                    padding="SAME"))
    variables = _np(ref.init(jax.random.PRNGKey(3), jnp.asarray(x),
                             update_stats=False))
    # One stored step first, so that u is no longer the init's draw.
    _, state = ref.apply(variables, jnp.asarray(x), update_stats=True,
                         mutable=["batch_stats"])
    variables = {"params": variables["params"], **_np(state)}

    def jax_loss(params, xx):
        out, mut = ref.apply({"params": params,
                              "batch_stats": variables["batch_stats"]}, xx,
                             update_stats=update_stats,
                             mutable=["batch_stats"])
        return jnp.sum(out * weight), (out, mut)

    (_, (out, mut)), (g_params, g_x) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                jnp.asarray(x))
    # flax's names at the root: "layer_instance/kernel/{u,sigma}".
    before, stored = variables["batch_stats"], mut["batch_stats"]
    conv = hific.Conv(5, 6, kernel, stride)
    sn = hific.SpectralNorm(6)
    conv.load_state_dict({k: torch.tensor(v) for k, v in
                          variables["params"]["layer_instance"].items()})
    sn.u.copy_(torch.tensor(before["layer_instance/kernel/u"]))
    tx = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    t_out = conv(tx, sn(conv.kernel, update_stats=update_stats))
    (t_out * torch.tensor(weight).permute(0, 3, 1, 2)).sum().backward()
    _close(t_out.permute(0, 2, 3, 1), out, 1e-5)
    g = g_params["layer_instance"]
    _close(conv.kernel.grad, g["kernel"], 1e-5)
    _close(conv.bias.grad, g["bias"], 1e-5)
    _close(tx.grad.permute(0, 2, 3, 1), g_x, 1e-5)
    _close(sn.u, stored["layer_instance/kernel/u"], 1e-6)
    np.testing.assert_allclose(
        float(sn.sigma), float(stored["layer_instance/kernel/sigma"]),
        rtol=1e-6)
    if not update_stats:
        np.testing.assert_array_equal(sn.u.numpy(),
                                      before["layer_instance/kernel/u"])


# -- Discriminator --------------------------------------------------------
_JD = jax_hific.Discriminator(**TINY_DISC)
# One compiled init of the tiny discriminator for every test here.
_disc_init = jax.jit(lambda key, x, lat: _JD.init(
    key, jnp.asarray(x), jnp.asarray(lat), update_stats=False))


def _tiny_disc_pair(seed=0):
    """(JAX tiny Discriminator, its variables, the port's carrying them,
    x, latent) at 2 x 32x32 with an 8-channel 8x8 latent."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    lat = rng.normal(0, 2, (2, 8, 8, 8)).astype(np.float32)
    jd = _JD
    variables = _np(_disc_init(jax.random.PRNGKey(seed), x, lat))
    disc = hific.Discriminator(8, **TINY_DISC)
    disc.load_state_dict(hific.disc_params_from_jax(variables))
    return jd, variables, disc, x, lat


_DISC = {}


def _disc_reference():
    """The tiny discriminator's JAX results with update_stats True and
    False -- logits, stored state and the gradients of a weighted sum of
    the logits in the parameters, the image and the latent -- from one
    compiled function."""
    if not _DISC:
        jd, variables, _, x, lat = _tiny_disc_pair()
        weight = np.random.RandomState(1).normal(
            0, 1, (2 * 8 * 8, 1)).astype(np.float32)

        def results(params, xx, ll):
            out = {}
            for flag in (True, False):
                def loss(p, a, b):
                    logits, mut = jd.apply(
                        {"params": p,
                         "batch_stats": variables["batch_stats"]},
                        a, b, update_stats=flag, mutable=["batch_stats"])
                    return jnp.sum(logits * weight), (logits, mut)
                out[flag] = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True)(params, xx, ll)
            return out

        _DISC.update(_np(jax.jit(results)(
            variables["params"], jnp.asarray(x), jnp.asarray(lat))))
        _DISC["weight"] = weight
    return _DISC


@pytest.mark.parametrize("update_stats", [True, False])
def test_discriminator_matches_jax(update_stats):
    """Logits, the stored state and the gradients in every parameter, the
    image and the latent of the tiny discriminator against JAX's."""
    _, _, disc, x, lat = _tiny_disc_pair()
    ref = _disc_reference()
    (_, (logits, mut)), grads = ref[update_stats]
    tx = torch.tensor(x).requires_grad_()
    tl = torch.tensor(lat).requires_grad_()
    t_logits = disc(tx, tl, update_stats=update_stats)
    (t_logits * torch.tensor(ref["weight"])).sum().backward()
    _close(t_logits, logits, 1e-5)
    want = hific.disc_params_from_jax({"params": grads[0],
                                       "batch_stats": {}})
    for k, p in disc.named_parameters():
        _close(p.grad, want[k], 1e-5)
    _close(tx.grad, grads[1], 1e-5)
    _close(tl.grad, grads[2], 1e-5)
    state = hific.disc_params_from_jax({"params": {}, **mut})
    for k, v in disc.named_buffers():
        _close(v, state[k], 1e-6)


def test_discriminator_state_names_at_hific_width():
    """The JAX Discriminator at the hific width (latent 220) maps onto the
    port's state_dict name for name and shape: 2,800,797 parameters, a
    (1, cout) u and a scalar sigma per convolution."""
    shapes = jax.eval_shape(lambda: jax_hific.Discriminator().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)),
        jnp.zeros((1, 16, 16, 220)), update_stats=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = hific.disc_params_from_jax(zeros)
    disc = hific.Discriminator(220)
    got = disc.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert sum(p.numel() for p in disc.parameters()) == 2800797
    assert got["SpectralNorm_4.u"].shape == (1, 512)


# -- HiFiCModel.forward(training=True) ------------------------------------
def _to_jax(state_dict):
    """The port's state_dict as the JAX HiFiCModel's params (the inverse
    of params_from_jax): a seeded port init stands in for a compiled JAX
    one, the same recipe, at no compile cost."""
    tree = {"hyperprior": {"matrices": [], "biases": [], "factors": []}}
    for name, value in state_dict.items():
        parts = name.split(".")
        if parts[0].startswith("hyperprior_"):
            tree["hyperprior"][parts[0][len("hyperprior_"):]].append(
                value.numpy().copy())
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.numpy().copy()
    return {"params": tree}


class _Case:
    """A JAX HiFiCModel with its params and the port's model carrying
    them, for one configuration of tests/test_torch_hific.py (the compact
    one stretched as there)."""

    def __init__(self, name, shape=(2, 64, 64, 3)):
        self.cfg = CONFIGS[name]
        self.tol = 1e-5 if name == "tiny" else 2e-5
        self.jax_model = jax_hific.HiFiCModel(
            cfg=jax_hific.HiFiCConfig(**self.cfg))
        self.model = hific.HiFiCModel(hific.HiFiCConfig(**self.cfg), seed=1)
        self.params = _to_jax(self.model.state_dict())
        if name == "compact":
            self.params = _stretch(self.params, self.cfg)
            self.model.load_state_dict(hific.params_from_jax(self.params))
        self.x = np.random.RandomState(4).randint(0, 256, shape).astype(
            np.float32)
        with torch.no_grad():
            y, z = self.model.encode(torch.tensor(self.x))
        self.shapes = (tuple(z.shape), tuple(y.shape))

    def noise(self, key):
        """The noise JAX's forward draws from ``key``, as the port's u."""
        (k1,) = jax.random.split(key, 1)
        return (torch.tensor(_uniform(k1, self.shapes[0])),
                torch.tensor(_uniform(key, self.shapes[1])))


@pytest.fixture(scope="module", params=["tiny", "compact"])
def case(request):
    return _Case(request.param)


def test_training_forward_matches_jax(case):
    """x_hat and y_hat within 1e-5 (2e-5 stretched) of JAX's largest
    magnitude, nbpp and qbpp within rtol 1e-5, with JAX's noise."""
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p, x, k: case.jax_model.apply(
        p, x, training=True, key=k))(case.params, jnp.asarray(case.x), key)
    with torch.no_grad():
        got = case.model(torch.tensor(case.x), training=True,
                         u=case.noise(key))
    assert got[2].shape == () and got[3].shape == ()
    _close(got[0], want[0], case.tol)
    _close(got[1], want[1], case.tol)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_generator_draws_z_then_y(case):
    """A generator draws z's noise first, then y's: the same outputs as
    those draws passed in as u."""
    gen = torch.Generator().manual_seed(5)
    x = torch.tensor(case.x)
    with torch.no_grad():
        by_gen = case.model(x, training=True, generator=gen)
        again = torch.Generator().manual_seed(5)
        u = tuple(torch.empty(s).uniform_(-0.5, 0.5, generator=again)
                  for s in case.shapes)
        by_u = case.model(x, training=True, u=u)
    for a, b in zip(by_gen, by_u):
        assert torch.equal(a, b)


def test_training_forward_needs_noise(case):
    with pytest.raises(ValueError):
        case.model(torch.tensor(case.x), training=True)


# -- rd_loss --------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 49999, 50000, 70000])
@pytest.mark.parametrize("qbpp", [0.05, 0.19, 0.21, 0.5])
def test_rd_loss_matches_jax(step, qbpp):
    """Below and above the target (0.2 before schedule_steps, 0.14 after),
    before and after the schedule switches."""
    cfg = hific.get_config("hific")
    args = (np.float32(812.5), np.float32(0.31), np.float32(qbpp))
    want = jax_hific.rd_loss(jax_hific.get_config("hific"),
                             *map(jnp.asarray, args), step)
    got = hific.rd_loss(cfg, *map(torch.tensor, args), step)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_rd_loss_weighs_the_rate_by_the_target():
    cfg = hific.get_config("hific")
    d, n = torch.tensor(1.0), torch.tensor(0.1)
    lo = hific.rd_loss(cfg, d, n, torch.tensor(0.05), 0)
    hi = hific.rd_loss(cfg, d, n, torch.tensor(0.50), 0)
    assert float(hi) > float(lo)


# -- three alternating g / d steps ----------------------------------------
@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """Random LPIPS weights (seed 3) in one npz that both packages
    load."""
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    np.savez(path, **{k: v.numpy() for k, v in
                      lpips.random_lpips_weights(seed=3).items()})
    return path


def test_gan_steps_track_optax(lpips_npz):
    """Three g steps, each followed by a d step, against JAX's
    make_train_steps with optax.adam(1e-4): the tiny model and the tiny
    discriminator from JAX's inits, LPIPS on (CP 0.15), batch 2 of 32x32,
    JAX's noise for every step.  Metrics within rtol 1e-4 at each step,
    the generator's and the discriminator's parameters within the rule of
    the module docstring after each, the discriminator's state within
    1e-6."""
    case = _Case("tiny", shape=(2, 32, 32, 3))
    jd, d_vars, disc, _, _ = _tiny_disc_pair()
    jm = case.jax_model
    # JAX's own GAN init (tests/test_hific.py), on a latent of y's shape
    # (the init draws from its key whatever the values).
    d_vars = _np(_disc_init(jax.random.PRNGKey(3), case.x / 255.0,
                            np.zeros(case.shapes[1], np.float32)))
    disc.load_state_dict(hific.disc_params_from_jax(d_vars))
    params, d_params = case.params, d_vars["params"]
    d_state = {"batch_stats": d_vars["batch_stats"]}
    g_opt, d_opt = optax.adam(LR), optax.adam(LR)
    g_state, d_opt_state = g_opt.init(params), d_opt.init(d_params)
    jax_g, jax_d = jax_hific.make_train_steps(
        jm, jd, g_opt, d_opt, lpips_weights_path=lpips_npz)
    g_step, d_step = hific.make_train_steps(
        case.model, disc,
        torch.optim.Adam(case.model.parameters(), lr=LR),
        torch.optim.Adam(disc.parameters(), lr=LR),
        lpips_weights_path=lpips_npz)
    x = jnp.asarray(case.x)
    key = jax.random.PRNGKey(11)
    for i in range(3):
        key, kg, kd = jax.random.split(key, 3)
        params, g_state, gm = jax_g(
            params, g_state, {"params": d_params, **d_state}, x, kg, i)
        tm = g_step(case.x, i, u=case.noise(kg))
        d_params, d_state, d_opt_state, dm = jax_d(
            d_params, d_state, d_opt_state, params, x, kd)
        tm.update(d_step(case.x, u=case.noise(kd)))
        gm.update(dm)
        assert set(tm) == {"g_loss", "nbpp", "qbpp", "distortion",
                           "d_loss"}
        for name, v in tm.items():
            assert v.shape == () and v.device.type == "cpu"
            np.testing.assert_allclose(float(v), float(gm[name]), rtol=1e-4,
                                       err_msg=f"{name}@{i}")
        want = {**hific.params_from_jax(_np(params)),
                **{f"disc.{k}": v for k, v in hific.disc_params_from_jax(
                    {"params": _np(d_params), "batch_stats": {}}).items()}}
        got = {**dict(case.model.named_parameters()),
               **{f"disc.{k}": v for k, v in disc.named_parameters()}}
        assert set(got) == set(want)
        for k, v in got.items():
            v, w = v.detach().numpy(), want[k].numpy()
            err = np.abs(v - w)
            off = err > 0.2 * LR + 1e-4 * np.abs(w)
            assert off.sum() <= 1e-5 * off.size, f"{k}@{i}"
            assert err.max() <= 6 * LR, f"{k}@{i}"
        state = hific.disc_params_from_jax({"params": {},
                                            **_np(d_state)})
        for k, v in disc.named_buffers():
            _close(v, state[k], 1e-6)


# -- train ----------------------------------------------------------------
@pytest.mark.parametrize("use_gan", [False, True])
def test_train_on_the_cpu(use_gan):
    """tests/test_lvac_hific_train.py's loops on the port: 2 steps at batch
    1 of 32x32, finite metrics, the discriminator only with the GAN."""
    cfg = hific.HiFiCConfig(
        num_down=2, num_filters_base=4, num_filters_bottleneck=8,
        num_residual_blocks=1, hyper_filters=4, use_gan=use_gan)
    seen = []

    def batches():
        rng = np.random.RandomState(0)
        while True:
            seen.append(rng.randint(0, 256, (1, 32, 32, 3)).astype(
                np.float32))
            yield seen[-1]

    model, disc = hific.train(cfg, steps=2, batch_size=1, patchsize=32,
                              log_every=0, device="cpu",
                              data_iter=batches())
    assert len(seen) == 2
    assert isinstance(model, hific.HiFiCModel)
    assert (disc is not None) == use_gan
    with torch.no_grad():
        out = model(torch.tensor(seen[0]), training=False)
    assert all(bool(torch.isfinite(t).all()) for t in out)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = hific.HiFiCConfig(**CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hific.train(cfg, steps=1)
