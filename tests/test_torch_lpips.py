"""The port's LPIPS (models/lpips.py) against the JAX package's, on the CPU.

Both packages run the same weights: an npz of the port's
``random_lpips_weights`` that each loads through its own
``load_lpips_weights``.  Images of 2 x 32x32 and 2 x 40x48 (the second
pools odd sizes: 20x24 -> 10x12 -> 5x6 -> 2x3).  Tolerances: the VGG16
taps within 1e-5 of their largest magnitude; the distances within rtol
1e-5; the gradient of the summed distance in y within 1e-4 of its
largest magnitude (the unit norm divides by small feature norms).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import lpips as jax_lpips
from compression_tpu_torch.models import lpips

torch.set_num_threads(1)

SHAPES = {"32x32": (2, 32, 32, 3), "40x48": (2, 40, 48, 3)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(npz path, the port's weights loaded from it, JAX's)."""
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    params = lpips.random_lpips_weights(seed=4)
    # A head with negative entries: both loaders clip them to zero.
    params["lin2_w"] = params["lin2_w"] * torch.linspace(-1, 3, 256)
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return (path, lpips.load_lpips_weights(path, device="cpu"),
            jax_lpips.load_lpips_weights(path))


def _images(name, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 1, SHAPES[name]).astype(np.float32),
            rng.uniform(0, 1, SHAPES[name]).astype(np.float32))


def _close(mine, ref, tol):
    ref = np.asarray(ref)
    mine = np.asarray(mine.detach())
    assert mine.shape == ref.shape
    err = float(np.abs(mine - ref).max()) / float(np.abs(ref).max())
    assert err <= tol, err


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_vgg16_features_match_jax(weights, name):
    _, mine, ref = weights
    x, _ = _images(name)
    want = jax.jit(jax_lpips.vgg16_features)(ref, jnp.asarray(x) * 2 - 1)
    got = lpips.vgg16_features(mine, torch.tensor(x) * 2 - 1)
    assert len(got) == 5
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_lpips_and_its_gradient_match_jax(weights, name):
    """The [N] distances, and the gradient of their sum in y."""
    _, mine, ref = weights
    x, y = _images(name)

    def ref_fn(xx, yy):
        out, vjp = jax.vjp(lambda b: jax_lpips.lpips(ref, xx, b), yy)
        return out, vjp(jnp.ones_like(out))[0]

    want, grad = jax.jit(ref_fn)(jnp.asarray(x), jnp.asarray(y))
    ty = torch.tensor(y).requires_grad_()
    got = lpips.lpips(mine, torch.tensor(x), ty)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    _close(ty.grad, grad, 1e-4)


def test_lpips_input_range_matches_jax(weights):
    _, mine, ref = weights
    x, y = _images("32x32", seed=1)
    want = jax_lpips.lpips(ref, jnp.asarray(x) * 255, jnp.asarray(y) * 255,
                           input_range=(0.0, 255.0))
    got = lpips.lpips(mine, torch.tensor(x) * 255, torch.tensor(y) * 255,
                      input_range=(0.0, 255.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_zero_for_identical_positive_and_symmetric(weights):
    """tests/test_hific.py's LPIPS checks on the port."""
    _, mine, _ = weights
    x, y = (torch.tensor(a) for a in _images("32x32", seed=2))
    same = lpips.lpips(mine, x, x)
    diff = lpips.lpips(mine, x, y)
    assert same.shape == (2,)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-5)
    assert bool((diff > 0).all())
    np.testing.assert_allclose(lpips.lpips(mine, y, x).numpy(),
                               diff.numpy(), rtol=1e-5)


def test_npz_round_trip(weights):
    """Both loaders read the npz to the same weights, the heads clipped
    to >= 0, everything else as saved."""
    path, mine, ref = weights
    saved = dict(np.load(path))
    assert set(mine) == set(ref) == set(saved)
    for k, v in mine.items():
        assert v.dtype == torch.float32 and not v.requires_grad
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
        want = np.clip(saved[k], 0, None) if k.startswith("lin") else \
            saved[k]
        np.testing.assert_array_equal(v.numpy(), want)
    assert float(mine["lin2_w"].min()) == 0.0


def test_random_weights_follow_the_jax_recipe():
    """The JAX package's shapes, He normal kernels (std sqrt(2 / (9 cin))),
    zero biases, heads 1 / C; a seed gives one set."""
    mine = lpips.random_lpips_weights(seed=0)
    shapes = jax.eval_shape(lambda: jax_lpips.random_lpips_weights(seed=0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
    for i, cout in enumerate(lpips._VGG_CHANNELS):
        w = mine[f"conv{i}_w"]
        std = np.sqrt(2.0 / (9 * w.shape[2]))
        assert abs(float(w.std()) / std - 1) < 0.05, i
        assert not bool(mine[f"conv{i}_b"].any())
    for j, conv_i in enumerate(lpips._STAGE_ENDS):
        c = lpips._VGG_CHANNELS[conv_i]
        np.testing.assert_array_equal(mine[f"lin{j}_w"].numpy(),
                                      np.full(c, 1.0 / c, np.float32))
    again = lpips.random_lpips_weights(
        generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(mine[k], again[k]) for k in mine)


def test_load_raises_when_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        lpips.load_lpips_weights(str(tmp_path / "none.npz"), device="cpu")


def test_make_lpips_loss(weights, tmp_path):
    """The file's weights when it exists, else the random ones of the
    seed; frozen weights, a gradient for x_hat only."""
    path, mine, _ = weights
    x, y = (torch.tensor(a) for a in _images("32x32", seed=3))
    loaded = lpips.make_lpips_loss(path, device="cpu")
    np.testing.assert_allclose(float(loaded(x, y)),
                               float(lpips.lpips(mine, x, y).mean()),
                               rtol=1e-6)
    fallback = lpips.make_lpips_loss(str(tmp_path / "none.npz"), seed=4,
                                     device="cpu")
    own = lpips.random_lpips_weights(seed=4)
    ty = y.clone().requires_grad_()
    loss = fallback(x, ty)
    np.testing.assert_allclose(float(loss),
                               float(lpips.lpips(own, x, y).mean()),
                               rtol=1e-6)
    loss.backward()
    assert ty.grad is not None and bool(ty.grad.abs().sum() > 0)


def test_make_lpips_loss_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lpips.make_lpips_loss()
