"""The port's image metrics (util/metrics.py) against the JAX package's, on
the CPU.

PSNR, SSIM and MS-SSIM on pairs of 2 x 176x176 images (176 is the smallest
side MS-SSIM's five scales take: 11 pixels at the last) and one 177x181
image (odd sizes through the average pools), as batches and as one HWC
image (within rtol 1e-6 of a batch of one); the Fréchet distance, FID and
KID on feature sets drawn from Gaussians, and the pooled VGG16 embedding
on 4 x 32x32 images.  Numpy inputs go to the card unless device="cpu" is
passed (each metric raises without CUDA otherwise); tensor inputs stay
where they lie.
Tolerances: PSNR, SSIM and MS-SSIM within rtol 1e-5; the Fréchet distance
and FID within rtol 1e-4 of JAX's (float32 eigendecompositions on both
sides, ~1e-6 of the trace terms they cancel against); KID within 1e-5 of
the kernel sums' scale; the embedding within 1e-5 of its largest
magnitude.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from compression_tpu.util import metrics as jax_metrics
from compression_tpu_torch.models import lpips
from compression_tpu_torch.util import metrics

torch.set_num_threads(1)


def _pair(shape, seed=0, sigma=12.0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, sigma, shape), 0, 255).astype(np.float32)
    return a, b


PAIRS = {"2x176x176": ((2, 176, 176, 3), 12.0),
         "2x176x176_near": ((2, 176, 176, 3), 2.0),
         "1x177x181": ((1, 177, 181, 3), 30.0)}


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("metric", ["psnr", "ssim", "msssim"])
def test_image_metrics_match_jax(metric, name):
    shape, sigma = PAIRS[name]
    a, b = _pair(shape, seed=len(name), sigma=sigma)
    want = np.asarray(getattr(jax_metrics, metric)(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = getattr(metrics, metric)(a, b, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("metric", ["ssim", "msssim"])
def test_one_hwc_image_is_a_batch_of_one(metric):
    a, b = _pair((176, 176, 3), seed=3)
    one = getattr(metrics, metric)(a, b, device="cpu")
    batch = getattr(metrics, metric)(a[None], b[None], device="cpu")
    assert one.shape == (1,)
    np.testing.assert_allclose(one.numpy(), batch.numpy(), rtol=1e-6)


def test_psnr_known_value_and_identical():
    """tests/test_metrics.py's values on the port."""
    a = np.zeros((1, 8, 8, 3), np.float32)
    np.testing.assert_allclose(metrics.psnr(a, a + 16.0, device="cpu").numpy(),
                               20 * np.log10(255 / 16), rtol=1e-5)
    assert float(metrics.psnr(a, a, device="cpu")[0]) > 100


def _features(seed, n=64, d=16, shift=0.0):
    rng = np.random.RandomState(seed)
    mix = rng.normal(0, 0.3, (d, d))
    return (rng.normal(0, 1, (n, d)) @ mix + shift).astype(np.float32)


def test_frechet_distance_and_fid_match_jax():
    a, b = _features(0), _features(1, shift=0.5)
    want = float(jax_metrics.fid_from_features(a, b))
    got = metrics.fid_from_features(a, b, device="cpu")
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    mu1, mu2 = a.mean(0), b.mean(0)
    c1, c2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    want = float(jax_metrics.frechet_distance(mu1, c1.astype(np.float32),
                                              mu2, c2.astype(np.float32)))
    got = metrics.frechet_distance(mu1, c1.astype(np.float32), mu2,
                                   c2.astype(np.float32), device="cpu")
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_fid_of_one_feature():
    """D = 1: the covariance is a 1x1 matrix (atleast_2d)."""
    a, b = _features(2, d=1), _features(3, d=1, shift=1.0)
    got = metrics.fid_from_features(a, b, device="cpu")
    np.testing.assert_allclose(float(got),
                               float(jax_metrics.fid_from_features(a, b)),
                               rtol=1e-4)


def test_fid_matches_analytic_gaussian():
    """FID(N(0, I), N(m, I)) = ||m||^2 (tests/test_metrics.py's check)."""
    rng = np.random.RandomState(0)
    a = rng.normal(0, 1, (4000, 4)).astype(np.float32)
    b = (rng.normal(0, 1, (4000, 4)) + 2.0).astype(np.float32)
    got = metrics.fid_from_features(a, b, device="cpu")
    np.testing.assert_allclose(float(got), 16.0, rtol=0.05)


@pytest.mark.parametrize("block_size", [None, 16, 50])
def test_kid_matches_jax(block_size):
    a, b = _features(4), _features(5, shift=0.3)
    want = float(jax_metrics.kid_from_features(a, b, block_size=block_size))
    got = metrics.kid_from_features(a, b, block_size=block_size,
                                    device="cpu")
    assert got.shape == ()
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want))


def test_image_perceptual_features_match_jax():
    params = lpips.random_lpips_weights(seed=6)
    ref = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    images = np.random.RandomState(7).randint(0, 256, (4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax_metrics.image_perceptual_features(ref, images))
    got = metrics.image_perceptual_features(params, images, device="cpu")
    assert got.shape == (4, sum(lpips._VGG_CHANNELS[i]
                                for i in lpips._STAGE_ENDS))
    err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
    assert err <= 1e-5, err


_IMAGES = np.zeros((1, 176, 176, 3), np.float32)
_FEATS = _features(8)
DEFAULT_DEVICE_CALLS = {
    "psnr": lambda **kw: metrics.psnr(_IMAGES, _IMAGES, **kw),
    "ssim": lambda **kw: metrics.ssim(_IMAGES, _IMAGES, **kw),
    "msssim": lambda **kw: metrics.msssim(_IMAGES, _IMAGES, **kw),
    "frechet_distance": lambda **kw: metrics.frechet_distance(
        np.zeros(2, np.float32), np.eye(2, dtype=np.float32),
        np.ones(2, np.float32), np.eye(2, dtype=np.float32), **kw),
    "fid_from_features": lambda **kw: metrics.fid_from_features(
        _FEATS, _FEATS, **kw),
    "kid_from_features": lambda **kw: metrics.kid_from_features(
        _FEATS, _FEATS, **kw),
    "image_perceptual_features": lambda **kw: (
        metrics.image_perceptual_features(
            lpips.random_lpips_weights(seed=0), _IMAGES[:, :32, :32], **kw)),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_metrics_on_numpy_default_to_the_card(name, monkeypatch):
    """Numpy inputs go to the card unless the caller asks for the CPU: a
    call without CUDA raises, and runs with device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = DEFAULT_DEVICE_CALLS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert call(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("metric", ["psnr", "ssim", "msssim"])
def test_metrics_leave_tensors_where_they_lie(metric, monkeypatch):
    """Tensor inputs are not moved: CPU tensors compute on the CPU under the
    default device, and agree with the numpy call on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _pair((1, 176, 176, 3), seed=9)
    got = getattr(metrics, metric)(torch.as_tensor(a), torch.as_tensor(b))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), getattr(metrics, metric)(a, b, device="cpu").numpy())
